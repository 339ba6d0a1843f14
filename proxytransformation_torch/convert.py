"""JAX-package variables → the port's state_dict.

`state_dict_from_jax` is the inverse of the JAX package's
`converter/torch_weights.py::convert_detector`: it turns a
`{'params', 'batch_stats'}` tree of arrays back into tensors under the
upstream key names, for every submodule of the grounder's predict path,
of the detector (`Embodied3DDetector`: backbone, backbone_3d and the
FCAF3D bbox_head) and of the occupancy models (backbone, feat_proj, the
ImVoxel neck_3d, the occupancy bbox_head and DenseFusion's point_proj),
with the text tower of any t_type (the inverses of the JAX package's
`convert_hf_clip_text`, `convert_hf_bert_text`, `convert_hf_t5_encoder`,
`convert_open_clip_text` and `convert_hf_deberta`) and any MinkResNet
(bottleneck blocks, the batch-norm stem; brick stages share the cell
format's tree), and of the standalone `ChannelMapper` and
`TransformerEncoder` of models/misc.py. It reads plain nested dicts of
arrays; nothing here imports JAX.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

Tree = Mapping[str, object]


def _count(tree: Tree, pattern: str) -> int:
    idx = [int(m.group(1)) for k in tree if (m := re.fullmatch(pattern, k))]
    return max(idx) + 1 if idx else 0


class _Writer:
    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value) -> None:
        self.sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def linear(self, key: str, p: Tree) -> None:
        self.put(key + '.weight', np.asarray(p['kernel']).T)
        if 'bias' in p:
            self.put(key + '.bias', p['bias'])

    def conv1x1(self, key: str, p: Tree, spatial_dims: int) -> None:
        w = np.asarray(p['kernel']).T
        self.put(key + '.weight', w.reshape(w.shape + (1, ) * spatial_dims))
        if 'bias' in p:
            self.put(key + '.bias', p['bias'])

    def ln(self, key: str, p: Tree) -> None:
        self.put(key + '.weight', p['scale'])
        self.put(key + '.bias', p['bias'])

    def bn(self, key: str, p: Tree, s: Tree) -> None:
        self.ln(key, p)
        self.put(key + '.running_mean', s['mean'])
        self.put(key + '.running_var', s['var'])

    def me_conv(self, key: str, p: Tree) -> None:
        k = np.asarray(p['kernel'])
        self.put(key + '.kernel', k[0] if k.shape[0] == 1 else k)


def _preshape(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    for name in ('get_offsets', 'simple_encoder'):
        w.conv1x1(f'{pre}{name}.mlp.0', p[name]['Dense_0'], 2)
        w.bn(f'{pre}{name}.mlp.1', p[name]['BatchNorm_0'],
             s[name]['BatchNorm_0'])
    w.conv1x1(pre + 'get_offsets.channel_mapper',
              p['get_offsets']['Dense_1'], 1)
    w.conv1x1(pre + 'channel_mapper', p['channel_mapper'], 2)
    ap = p['attn_pool2d']
    w.put(pre + 'attn_pool2d.positional_embedding', ap['positional_embedding'])
    for proj in ('q_proj', 'k_proj', 'v_proj', 'c_proj'):
        w.linear(f'{pre}attn_pool2d.{proj}', ap[proj])
    w.ln(pre + 'norm_img', p['norm_img'])
    for branch, norm in (('textformer', 'text_norm'), ('imgformer', 'img_norm')):
        for i in range(_count(p, rf'{branch}_(\d+)')):
            blk, dst = p[f'{branch}_{i}'], f'{pre}{branch}.{i}'
            w.ln(dst + '.norm1', blk['norm1'])
            w.ln(dst + '.norm2', blk['norm2'])
            for lin in ('qkv', 'proxy_proj', 'proj'):
                w.linear(f'{dst}.attn.{lin}', blk['attn'][lin])
            for b in ('pb_bias', 'pc_bias', 'pr_bias'):
                w.put(f'{dst}.attn.{b}', blk['attn'][b])
            w.linear(dst + '.mlp.fc1', blk['mlp']['Dense_0'])
            w.linear(dst + '.mlp.fc2', blk['mlp']['Dense_1'])
            w.ln(f'{pre}{norm}.{i}', p[f'{norm}_{i}'])
    w.linear(pre + 'text_trans', p['text_trans'])
    w.linear(pre + 'img_trans', p['img_trans'])
    for bn in ('text_trans_norm', 'img_trans_norm'):
        w.bn(pre + bn, p[bn], s[bn])


def _backbone_3d(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    w.me_conv(pre + 'conv1', p['conv1'])
    if 'norm1' in s:          # stem BatchNorm variant
        w.bn(pre + 'norm1.bn', p['norm1'], s['norm1'])
    else:                     # stem InstanceNorm (affine)
        w.ln(pre + 'norm1', p['norm1'])
    for name in sorted(k for k in p if re.fullmatch(r'layer\d+_\d+', k)):
        stage, j = name[len('layer'):].split('_')
        dst = f'{pre}layer{stage}.{j}'
        blk, st = p[name], s[name]
        for c in (1, 2, 3):
            if f'conv{c}' in blk:
                w.me_conv(f'{dst}.conv{c}', blk[f'conv{c}'])
                w.bn(f'{dst}.norm{c}.bn', blk[f'norm{c}'], st[f'norm{c}'])
        if 'downsample_conv' in blk:
            w.me_conv(dst + '.downsample.0', blk['downsample_conv'])
            w.bn(dst + '.downsample.1.bn', blk['downsample_norm'],
                 st['downsample_norm'])


def _fpn_blocks(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    """The up and out blocks of MinkNeck and of the FCAF3D head."""
    for i in range(1, _count(p, r'up_block_(\d+)')):
        blk, st, dst = p[f'up_block_{i}'], s[f'up_block_{i}'], f'{pre}up_block_{i}'
        w.put(dst + '.0.kernel', blk['transpose_kernel'])
        w.bn(dst + '.1.bn', blk['norm1'], st['norm1'])
        w.me_conv(dst + '.3', blk['conv'])
        w.bn(dst + '.4.bn', blk['norm2'], st['norm2'])
    for i in range(_count(p, r'out_block_(\d+)')):
        blk, st, dst = p[f'out_block_{i}'], s[f'out_block_{i}'], f'{pre}out_block_{i}'
        w.me_conv(dst + '.0', blk['conv'])
        w.bn(dst + '.1.bn', blk['norm'], st['norm'])


def _dense(w: _Writer, key: str, p: Tree) -> None:
    """A flax Dense kept as a 1x1 sparse conv: `kernel` (C, out), `bias`."""
    w.put(key + '.kernel', p['kernel'])
    w.put(key + '.bias', p['bias'])


def _neck(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    _fpn_blocks(w, p, s, pre)
    _dense(w, pre + 'conv_cls', p['conv_cls'])


def _fcaf3d_head(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    _fpn_blocks(w, p, s, pre)
    for name in ('conv_center', 'conv_reg', 'conv_cls'):
        _dense(w, pre + name, p[name])
    for i in range(_count(p, r'scale_(\d+)')):
        w.put(f'{pre}scales.{i}.scale', np.asarray(p[f'scale_{i}'])[0])


def _attention(w: _Writer, key: str, a: Tree) -> None:
    """flax q/k/v/out projections → `MultiheadAttention`'s packed
    `attn.in_proj_*` and `attn.out_proj`."""
    qkv = ('q_proj', 'k_proj', 'v_proj')
    w.put(f'{key}.attn.in_proj_weight', np.concatenate(
        [np.asarray(a[n]['kernel']).T for n in qkv]))
    w.put(f'{key}.attn.in_proj_bias', np.concatenate(
        [np.asarray(a[n]['bias']) for n in qkv]))
    w.linear(f'{key}.attn.out_proj', a['out_proj'])


def _ffn(w: _Writer, key: str, p: Tree) -> None:
    w.linear(key + '.layers.0.0', p['Dense_0'])
    w.linear(key + '.layers.1', p['Dense_1'])


def _decoder(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    for pe in ('self_posembed', 'cross_posembed'):
        dst = f'{pre}{pe}.position_embedding_head'
        w.conv1x1(dst + '.0', p[pe]['conv1'], 1)
        w.bn(dst + '.1', p[pe]['bn'], s[pe]['bn'])
        w.conv1x1(dst + '.3', p[pe]['conv2'], 1)
    w.ln(pre + 'norm', p['norm'])
    for i in range(_count(p, r'layer_(\d+)')):
        lp, dst = p[f'layer_{i}'], f'{pre}layers.{i}'
        for attn in ('self_attn', 'cross_attn_text', 'cross_attn'):
            _attention(w, f'{dst}.{attn}', lp[attn])
        for n in range(4):
            w.ln(f'{dst}.norms.{n}', lp[f'norm{n}'])
        _ffn(w, dst + '.ffn', lp['ffn'])


def _channel_mapper(w: _Writer, p: Tree) -> None:
    for i in range(_count(p, r'conv_(\d+)')):
        w.linear(f'convs.{i}', p[f'conv_{i}'])


def _transformer_encoder(w: _Writer, p: Tree) -> None:
    for i in range(_count(p, r'attn_(\d+)')):
        dst = f'layers.{i}'
        _attention(w, dst + '.attn', p[f'attn_{i}'])
        w.ln(dst + '.norm1', p[f'norm1_{i}'])
        _ffn(w, dst + '.ffn', p[f'ffn_{i}'])
        w.ln(dst + '.norm2', p[f'norm2_{i}'])


def _head(w: _Writer, p: Tree, pre: str) -> None:
    cls = p.get('cls_branch', {})
    if 'log_scale' in cls:
        w.put(pre + 'cls_branches.0.log_scale', cls['log_scale'])
    if 'bias_value' in cls:
        w.put(pre + 'cls_branches.0.bias', cls['bias_value'])
    reg = p['reg_branch']
    n_fc = _count(reg, r'fc(\d+)')
    for f in range(n_fc):
        w.linear(f'{pre}reg_branches.0.{2 * f}', reg[f'fc{f}'])
    w.linear(f'{pre}reg_branches.0.{2 * n_fc}', reg['out'])


def _resnet(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    def conv(key, kernel):  # flax HWIO → torch OIHW
        w.put(key, np.transpose(np.asarray(kernel), (3, 2, 0, 1)))

    conv(pre + 'conv1.weight', p['conv1']['kernel'])
    w.bn(pre + 'bn1', p['bn1'], s['bn1'])
    for name in sorted(k for k in p if re.fullmatch(r'layer\d+_\d+', k)):
        stage, j = name[len('layer'):].split('_')
        dst = f'{pre}layer{stage}.{j}'
        blk, st = p[name], s[name]
        for c in (1, 2, 3):
            if f'conv{c}' in blk:
                conv(f'{dst}.conv{c}.weight', blk[f'conv{c}']['kernel'])
                w.bn(f'{dst}.bn{c}', blk[f'bn{c}'], st[f'bn{c}'])
        if 'downsample_conv' in blk:
            conv(dst + '.downsample.0.weight', blk['downsample_conv']['kernel'])
            w.bn(dst + '.downsample.1', blk['downsample_bn'],
                 st['downsample_bn'])


def _conv3d(w: _Writer, key: str, p: Tree) -> None:
    """flax 3D conv (kx, ky, kz, C_in, C_out) → nn.Conv3d (C_out, C_in,
    kx, ky, kz)."""
    w.put(key + '.weight', np.transpose(np.asarray(p['kernel']),
                                        (4, 3, 0, 1, 2)))
    if 'bias' in p:
        w.put(key + '.bias', p['bias'])


def _imvoxel_neck(w: _Writer, p: Tree, s: Tree, pre: str) -> None:
    for name in sorted(p):
        if name.startswith('lat_'):
            _conv3d(w, pre + name, p[name])
        else:       # down_i, down_ib, out_i: conv, BatchNorm, ReLU
            _conv3d(w, f'{pre}{name}.conv', p[name]['Conv_0'])
            w.bn(f'{pre}{name}.norm', p[name]['BatchNorm_0'],
                 s[name]['BatchNorm_0'])


def _occ_head(w: _Writer, p: Tree, pre: str) -> None:
    for name in sorted(p):
        _conv3d(w, pre + name, p[name])


def _text_encoder(w: _Writer, p: Tree, pre: str) -> None:
    pre = pre + 'text_model.'
    w.put(pre + 'embeddings.token_embedding.weight',
          p['token_embedding']['embedding'])
    w.put(pre + 'embeddings.position_embedding.weight',
          p['position_embedding'])
    for i in range(_count(p, r'layer_(\d+)')):
        lp, dst = p[f'layer_{i}'], f'{pre}encoder.layers.{i}.'
        w.ln(dst + 'layer_norm1', lp['layer_norm1'])
        w.ln(dst + 'layer_norm2', lp['layer_norm2'])
        for proj in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
            w.linear(dst + 'self_attn.' + proj, lp['self_attn'][proj])
        w.linear(dst + 'mlp.fc1', lp['fc1'])
        w.linear(dst + 'mlp.fc2', lp['fc2'])
    w.ln(pre + 'final_layer_norm', p['final_layer_norm'])


def _bert_tower(w: _Writer, p: Tree, pre: str) -> None:
    """Inverse of `convert_hf_bert_text` (BERT, Roberta, FLAVA)."""
    e = pre + 'embeddings.'
    w.put(e + 'word_embeddings.weight', p['word_embeddings']['embedding'])
    w.put(e + 'position_embeddings.weight', p['position_embeddings'])
    w.put(e + 'token_type_embeddings.weight', p['token_type_embeddings'])
    w.ln(e + 'LayerNorm', p['embeddings_norm'])
    for i in range(_count(p, r'layer_(\d+)')):
        lp, dst = p[f'layer_{i}'], f'{pre}encoder.layer.{i}.'
        for name in ('query', 'key', 'value'):
            w.linear(f'{dst}attention.self.{name}', lp['attention'][name])
        w.linear(dst + 'attention.output.dense', lp['attention']['output'])
        w.ln(dst + 'attention.output.LayerNorm', lp['attention_norm'])
        w.linear(dst + 'intermediate.dense', lp['intermediate'])
        w.linear(dst + 'output.dense', lp['output'])
        w.ln(dst + 'output.LayerNorm', lp['output_norm'])


def _t5_tower(w: _Writer, p: Tree, pre: str) -> None:
    """Inverse of `convert_hf_t5_encoder`."""
    w.put(pre + 'shared.weight', p['shared']['embedding'])
    w.put(pre + 'encoder.block.0.layer.0.SelfAttention.'
          'relative_attention_bias.weight', p['relative_attention_bias'])
    for i in range(_count(p, r'layer_(\d+)')):
        lp, dst = p[f'layer_{i}'], f'{pre}encoder.block.{i}.layer.'
        for name in ('q', 'k', 'v', 'o'):
            w.linear(f'{dst}0.SelfAttention.{name}', lp[name])
        w.put(dst + '0.layer_norm.weight', lp['pre_attn_norm']['scale'])
        w.linear(dst + '1.DenseReluDense.wi', lp['wi'])
        w.linear(dst + '1.DenseReluDense.wo', lp['wo'])
        w.put(dst + '1.layer_norm.weight', lp['pre_ff_norm']['scale'])
    w.put(pre + 'encoder.final_layer_norm.weight', p['final_norm']['scale'])


def _open_clip_tower(w: _Writer, p: Tree, pre: str) -> None:
    """Inverse of `convert_open_clip_text` (the bare layout)."""
    w.put(pre + 'token_embedding.weight', p['token_embedding']['embedding'])
    w.put(pre + 'positional_embedding', p['positional_embedding'])
    for i in range(_count(p, r'resblock_(\d+)')):
        lp, dst = p[f'resblock_{i}'], f'{pre}transformer.resblocks.{i}.'
        w.ln(dst + 'ln_1', lp['ln_1'])
        w.ln(dst + 'ln_2', lp['ln_2'])
        _attention(w, dst[:-1], lp['attn'])
        w.linear(dst + 'mlp.c_fc', lp['c_fc'])
        w.linear(dst + 'mlp.c_proj', lp['c_proj'])
    w.ln(pre + 'ln_final', p['ln_final'])


def _deberta_tower(w: _Writer, p: Tree, pre: str, heads: int) -> None:
    """Inverse of `convert_hf_deberta`: q/k/v interleaved per head into
    `in_proj` (head h's rows [3·h·hd, 3·(h+1)·hd) are its q, k, v)."""
    emb = np.asarray(p['word_embeddings']['embedding'])
    C = emb.shape[1]
    if heads is None:
        heads = {768: 12, 1024: 16, 1536: 24}.get(C)
    if heads is None:
        raise ValueError(f'DeBERTa width {C}: pass deberta_heads')
    w.put(pre + 'embeddings.word_embeddings.weight', emb)
    w.ln(pre + 'embeddings.LayerNorm', p['embeddings_norm'])
    w.put(pre + 'encoder.rel_embeddings.weight', p['rel_embeddings'])
    for i in range(_count(p, r'layer_(\d+)')):
        lp, dst = p[f'layer_{i}'], f'{pre}encoder.layer.{i}.'
        a = lp['attention']
        qkv = np.stack([np.asarray(a[n]['kernel']).T.reshape(heads, -1, C)
                        for n in ('q_proj', 'k_proj', 'v_proj')], axis=1)
        w.put(dst + 'attention.self.in_proj.weight', qkv.reshape(3 * C, C))
        w.put(dst + 'attention.self.q_bias', a['q_bias'])
        w.put(dst + 'attention.self.v_bias', a['v_bias'])
        w.linear(dst + 'attention.self.pos_proj', a['pos_proj'])
        w.linear(dst + 'attention.self.pos_q_proj', a['pos_q_proj'])
        w.linear(dst + 'attention.output.dense', a['output'])
        w.ln(dst + 'attention.output.LayerNorm', lp['attention_norm'])
        w.linear(dst + 'intermediate.dense', lp['intermediate'])
        w.linear(dst + 'output.dense', lp['output'])
        w.ln(dst + 'output.LayerNorm', lp['output_norm'])


def _text_tower(w: _Writer, p: Tree, pre: str,
                deberta_heads: Optional[int]) -> None:
    """The text tower of any t_type, told apart by its tree."""
    if 'rel_embeddings' in p:
        _deberta_tower(w, p, pre, deberta_heads)
    elif 'shared' in p:
        _t5_tower(w, p, pre)
    elif 'positional_embedding' in p:
        _open_clip_tower(w, p, pre)
    elif 'word_embeddings' in p:
        _bert_tower(w, p, pre)
    else:
        _text_encoder(w, p, pre)


def state_dict_from_jax(variables: Mapping[str, Tree],
                        deberta_heads: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """`{'params', 'batch_stats'}` of the JAX grounder, detector or
    occupancy model, or of a `ChannelMapper` or `TransformerEncoder`
    (arrays) → the port's state_dict; submodules absent from the tree are
    skipped. A DeBERTa text tower of a width other than
    768, 1024 or 1536 needs its head count (`deberta_heads`)."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    w = _Writer()
    if 'backbone' in params:
        _resnet(w, params['backbone'], stats['backbone'], 'backbone.')
    if 'text_encoder' in params:
        _text_tower(w, params['text_encoder'], 'text_encoder.', deberta_heads)
    if 'text_feat_map' in params:
        w.linear('text_feat_map', params['text_feat_map'])
    if 'preshape' in params:
        _preshape(w, params['preshape'], stats['preshape'], 'preshape.')
    if 'backbone_3d' in params:
        _backbone_3d(w, params['backbone_3d'], stats.get('backbone_3d', {}),
                     'backbone_3d.')
    for name in ('feat_proj', 'point_proj'):
        if name in params:
            w.linear(name, params[name])
    if 'neck_3d' in params and 'down_0' in params['neck_3d']:
        _imvoxel_neck(w, params['neck_3d'], stats['neck_3d'], 'neck_3d.')
    elif 'neck_3d' in params:
        _neck(w, params['neck_3d'], stats['neck_3d'], 'neck_3d.')
    if 'decoder' in params:
        _decoder(w, params['decoder'], stats['decoder'], 'decoder.')
    if 'bbox_head' in params and 'conv_center' in params['bbox_head']:
        _fcaf3d_head(w, params['bbox_head'], stats['bbox_head'],
                     'bbox_head.')
    elif 'bbox_head' in params and 'occ_0' in params['bbox_head']:
        _occ_head(w, params['bbox_head'], 'bbox_head.')
    elif 'bbox_head' in params:
        _head(w, params['bbox_head'], 'bbox_head.')
    _channel_mapper(w, params)
    _transformer_encoder(w, params)
    return w.sd

"""Fresh weights drawn as the JAX package's flax modules draw them.

`flax_init_(model, generator)` sets every parameter of the grounder, the
detector or an occupancy model by the initialiser its JAX twin declares (the draws differ:
another generator; the laws and constants are the same):

- Dense and Conv kernels (`Linear`, `Conv1x1`, the 2D ResNet's convs,
  the occupancy models' 3D convs, the attention's in-projection, the
  FCAF3D head's `conv_center` / `conv_reg`): lecun normal, a normal
  truncated at two standard deviations with variance 1 / fan_in; their
  biases zero;
- sparse conv and generative transpose kernels: variance scaling 2.0 by
  fan_out (K³·C_out), truncated normal (models/sparse_resnet.py:28,
  sparse_neck.py:61);
- the classification layers of MinkNeck and of the FCAF3D head: kernel
  normal(0.01), bias -log(0.99 / 0.01) = -4.595 (sparse_neck.py:131-132,
  fcaf3d_head.py:101-103);
- norm scales (BatchNorm, InstanceNorm, LayerNorm) and the head's
  `scales.{i}`: ones; norm biases zero; running means 0, variances 1;
- the grounding head: the contrastive bias -4.595, the last regression
  layer's kernel zero and its bias 0 on the two first outputs and -2 on
  the rest (grounding_head.py:44-49, 75-79);
- the preshape: its proxy biases 0.02 · a normal truncated to [-2, 2]
  (preshape.py:48-51, 199-201), its pooling's positional embedding
  N(0, 1/c) (:141-142);
- the text towers: token embeddings N(0, 1/width) (flax `nn.Embed`);
  the CLIP and open_clip position embeddings normal(0.01)
  (text_encoder.py:88-89, text_variants.py:364-366); BERT's and
  Roberta's position and token-type embeddings, T5's relative attention
  bias and DeBERTa's `rel_embeddings` normal(0.02) (text_variants.py:
  95-106, 190-192, 320-322); DeBERTa's `q_bias` / `v_bias` zero and
  T5's RMSNorm scales ones (:232-233, :127).

A parameter no rule covers raises. `layers.random_init_` (N(0, 0.02²)
everywhere) stays for the parity tests.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .fcaf3d_head import PRIOR_BIAS, _Scale
from .grounding_head import ContrastiveEmbed, RegBranch
from .layers import Conv1x1
from .norms import BatchNormParams, MaskedInstanceNorm
from .preshape import AttentionPool2d, ProxyAttention
from .resnet import _Conv2d
from .sparse_neck import _ConvCls, _Transpose
from .sparse_resnet import SparseConv
from .text_variants import OpenCLIPTextEncoder, T5RMSNorm

# the text towers' parameters flax draws from normal(0.02)
_NORMAL_002 = ('position_embeddings', 'token_type_embeddings',
               'relative_attention_bias', 'rel_embeddings')

# the standard deviation of a standard normal truncated to [-2, 2]
# (flax's variance_scaling divides by it)
TRUNCATED_STD = 0.87962566103423978


def _normal(shape, std, gen):
    return torch.randn(shape, generator=gen) * std


def _truncated(shape, std, gen):
    """std · a standard normal truncated to [-2, 2]."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def _variance_scaling(shape, scale, fan, gen):
    return _truncated(shape, math.sqrt(scale / fan) / TRUNCATED_STD, gen)


def _reg_out_bias(n):
    b = np.zeros(n, np.float32)
    b[2:] = -2.0
    return torch.from_numpy(b)


def _draw(mod: nn.Module, mod_name: str, leaf: str, p: torch.Tensor,
          gen) -> torch.Tensor:
    """The initial value of parameter `leaf` of module `mod`."""
    shape = p.shape
    zeros, ones = torch.zeros(shape), torch.ones(shape)
    if leaf == 'bias' and isinstance(mod, (nn.Linear, Conv1x1, nn.Conv3d)):
        return zeros
    if isinstance(mod, (nn.Linear, Conv1x1)):
        return _variance_scaling(shape, 1.0, shape[1], gen)  # (out, in, ..)
    if isinstance(mod, (_Conv2d, nn.Conv3d)):
        return _variance_scaling(shape, 1.0, math.prod(shape[1:]), gen)
    if leaf == 'in_proj_weight':
        return _variance_scaling(shape, 1.0, shape[1], gen)
    if leaf == 'in_proj_bias':
        return zeros
    if isinstance(mod, (BatchNormParams, MaskedInstanceNorm, nn.LayerNorm)):
        return ones if leaf == 'weight' else zeros
    if isinstance(mod, SparseConv):
        k3 = shape[0] if len(shape) == 3 else 1
        return _variance_scaling(shape, 2.0, k3 * shape[-1], gen)
    if isinstance(mod, _Transpose):
        return _variance_scaling(shape, 2.0, shape[0] * shape[2], gen)
    if isinstance(mod, _ConvCls):
        if mod_name.endswith('conv_cls'):
            return (_normal(shape, 0.01, gen) if leaf == 'kernel'
                    else torch.full(shape, PRIOR_BIAS))
        return (_variance_scaling(shape, 1.0, shape[0], gen)
                if leaf == 'kernel' else zeros)
    if isinstance(mod, _Scale):
        return ones
    if isinstance(mod, nn.Embedding):
        if mod_name.endswith('position_embedding'):
            return _normal(shape, 0.01, gen)
        if mod_name.endswith(_NORMAL_002):
            return _normal(shape, 0.02, gen)
        return _normal(shape, math.sqrt(1.0 / shape[1]), gen)
    if isinstance(mod, T5RMSNorm):
        return ones
    if isinstance(mod, OpenCLIPTextEncoder):      # positional_embedding
        return _normal(shape, 0.01, gen)
    if leaf in ('q_bias', 'v_bias'):              # DeBERTa
        return zeros
    if isinstance(mod, AttentionPool2d):
        return _normal(shape, 1.0, gen) / shape[-1] ** 0.5
    if isinstance(mod, ProxyAttention):
        return _truncated(shape, 0.02, gen)
    if isinstance(mod, ContrastiveEmbed):
        return torch.full(shape, PRIOR_BIAS)
    raise TypeError(f'{mod_name}.{leaf} ({type(mod).__name__}): no flax '
                    'initialiser is known for it')


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every parameter of `model` drawn by its flax initialiser from
    `generator` (a CPU generator: the same weights on every device), the
    running statistics reset. Returns `model`."""
    last_reg = {id(m[-1]) for m in model.modules()
                if isinstance(m, RegBranch)}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if id(mod) in last_reg:
                # the grounding head's last regression layer
                value = (torch.zeros(p.shape) if leaf == 'weight'
                         else _reg_out_bias(p.shape[0]))
            else:
                value = _draw(mod, mod_name, leaf, p, generator)
            p.copy_(value.to(p.dtype))
    for name, b in model.named_buffers():
        if name.endswith('running_mean'):
            b.zero_()
        elif name.endswith('running_var'):
            b.fill_(1.0)
    return model


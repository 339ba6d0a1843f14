"""Packaging (reference surface: setup.py — pip package, no ext_modules;
the optional native data kernels build separately via native/build.sh)."""
from setuptools import find_packages, setup

setup(
    name='proxytransformation_tpu',
    version='0.1.0',
    description='TPU-native ego-centric 3D visual grounding '
                '(ProxyTransformation / EmbodiedScan re-designed for '
                'JAX/XLA/Pallas)',
    # proxytransformation_torch is the PyTorch/CUDA port (needs torch;
    # its CUDA kernels build from proxytransformation_torch/csrc with nvcc)
    packages=find_packages(exclude=('tests', 'tools', 'configs')),
    package_data={'proxytransformation_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy', 'scipy',
    ],
    extras_require={
        'data': ['opencv-python', 'pillow'],
        'visual': ['matplotlib', 'open3d'],
        'text': ['transformers'],
        'torch': ['torch'],
    },
)

"""PyTorch + CUDA port of the block-sparse co-design system (``repro``).

Same subpackages and module names as the JAX package: ``configs``, ``core``,
``kernels``, ``models``, ``serving``, ``checkpoint``, ``optim``, ``data``,
``launch``, ``runtime``. The entry points run
on the CUDA card unless given ``device='cpu'``; there every kernel wrapper
runs its plain PyTorch version.
"""

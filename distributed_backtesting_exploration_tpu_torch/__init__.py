"""PyTorch + CUDA port of the distributed backtesting framework, for one
NVIDIA H100.

The JAX package ``distributed_backtesting_exploration_tpu`` beside this one
is the reference: every module here mirrors the module path of its
counterpart there, and the tests hold each against it on shared inputs.
This package never imports JAX or any module of the reference package; what
it needs from a numpy-only reference module it keeps as its own copy.

Device policy (:mod:`.device`): entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; asking for ``cuda`` on a machine without a
GPU raises. On a CUDA tensor the fused sweep launches the hand-written
kernel (``csrc/fused_sma.cu``) or raises; only a CPU tensor takes the plain
PyTorch version of the same function.

Import alias used in the docs and tests::

    import distributed_backtesting_exploration_tpu_torch as dbxt
"""

import torch

__version__ = "0.1.0"

# Full-f32 matrix products and convolutions, set once for the process. The
# reference selects each combo's fast-minus-slow SMA at full f32 precision
# because a reduced-precision pass flips sign(fast - slow) near crossovers
# (reference ops/fused.py `_sma_select_and_score`); TF32 keeps ~3 decimal
# digits and would flip them the same way in any plain-PyTorch contraction.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import models, ops, parallel, utils  # noqa: E402,F401

"""mosfhet_torch: TFHE (FHE over the torus) in PyTorch, with CUDA kernels
written by hand for NVIDIA Hopper.

The port of the repository's TPU package, module for module.  Torus words
are int64 tensors holding u64 bits, or int32 tensors holding u32 bits at the
32-bit torus (``MOSFHET_TORUS_BITS=32`` at import, the reference's
``-DTORUS32``); all ciphertext arithmetic is exact wraparound mod 2^64 (or
2^32) through a CRT-NTT, so given the same key material and inputs the port
produces the same words as the TPU package.

Entry points run on the CUDA card unless the caller passes a device
(``device="cpu"``); without a card and without a device they raise.
"""

from . import params
from . import torus
from . import rng
from . import ntt
from . import polynomial
from . import tlwe
from . import trlwe
from . import trgsw
from . import bootstrap
from . import seeded
from . import keyswitch
from . import product
from . import bootstrap_ga
from . import bridge
from . import io
from . import parallel
from .ops import pbs_kernel
from ._device import default_device
from .params import PARAM_REGISTRY, TFHEParams, get_params

__version__ = "0.1.0"

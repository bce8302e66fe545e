"""Parameter sets as first-class named configs.

The port's own copy of the TPU package's registry: importing that package
would pull in its whole framework, so the table is kept here and a test
holds the two equal field by field.  Values are the reference's
per-harness consts (`test/tests.c:36-63`, `test/benchmark.c:49-76`,
`applications/.../ufhe.c:18-20`).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TFHEParams:
    """TFHE parameter set.

      n        : LWE dimension
      N        : ring/polynomial dimension, power of two
      k        : number of mask polynomials in TRLWE
      l        : gadget (TRGSW) decomposition length
      Bg_bit   : gadget base bits (Bg = 2**Bg_bit)
      t        : key-switching decomposition length
      base_bit : key-switching base bits
      lwe_sigma, rlwe_sigma : noise std-dev as fraction of the torus
    """

    n: int
    N: int
    k: int
    l: int
    Bg_bit: int
    t: int
    base_bit: int
    lwe_sigma: float
    rlwe_sigma: float
    name: str = ""

    @property
    def log_N(self) -> int:
        return int(math.log2(self.N))

    @property
    def log_N2(self) -> int:
        """log2(2N): the blind-rotate exponent precision (`bootstrap.c:108`)."""
        return self.log_N + 1

    @property
    def Bg(self) -> int:
        return 1 << self.Bg_bit

    @property
    def base(self) -> int:
        return 1 << self.base_bit

    def __post_init__(self):
        if self.N & (self.N - 1):
            raise ValueError("N must be a power of two")
        if self.l * self.Bg_bit > 64 or self.t * self.base_bit > 64:
            raise ValueError("decomposition wider than the 64-bit torus")


SET_1 = TFHEParams(
    n=585, N=1024, k=1, l=2, Bg_bit=8, t=5, base_bit=2,
    lwe_sigma=9.141776004202573e-5, rlwe_sigma=2.989040792967434e-8,
    name="SET_1",
)

SET_2 = TFHEParams(
    n=744, N=2048, k=1, l=1, Bg_bit=23, t=5, base_bit=3,
    lwe_sigma=7.747831515176779e-6, rlwe_sigma=2.2148688116005568e-16,
    name="SET_2",
)

SET_3 = TFHEParams(
    n=807, N=4096, k=1, l=1, Bg_bit=22, t=5, base_bit=3,
    lwe_sigma=1.0562341599676662e-6, rlwe_sigma=2.168404344971009e-19,
    name="SET_3",
)

# TFHEpp Level-2: the reference's default test/bench parameters.
TFHEPP_L2 = TFHEParams(
    n=632, N=2048, k=1, l=4, Bg_bit=9, t=8, base_bit=4,
    lwe_sigma=3.0517578125e-05,        # 2^-15
    rlwe_sigma=5.684341886080802e-14,  # 2^-44
    name="TFHEPP_L2",
)

UFHE_SET0 = TFHEParams(
    n=630, N=2048, k=1, l=6, Bg_bit=7, t=6, base_bit=2,
    lwe_sigma=3.0517578125e-05,        # 2^-15
    rlwe_sigma=5.684341886080802e-14,  # 2^-44
    name="UFHE_SET0",
)

# Tiny parameters for fast unit tests (no security).
TOY = TFHEParams(
    n=16, N=64, k=1, l=4, Bg_bit=9, t=8, base_bit=4,
    lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44,
    name="TOY",
)

TOY_K2 = TFHEParams(
    n=16, N=64, k=2, l=3, Bg_bit=8, t=6, base_bit=4,
    lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44,
    name="TOY_K2",
)

PARAM_REGISTRY = {
    p.name: p for p in (SET_1, SET_2, SET_3, TFHEPP_L2, UFHE_SET0, TOY, TOY_K2)
}


def get_params(name: str) -> TFHEParams:
    return PARAM_REGISTRY[name]

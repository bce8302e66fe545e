"""The roofline of the port on an NVIDIA H100: the least time the card needs
for a kernel's work, and the counts of a whole call.

The reference frames cost as FFT counts (`test/benchmark_arith.c`); on the
card the work is counted in the two resources that bound these kernels:

- INT32 operations: every modular product is integer multiplies (a Shoup
  product 3, a product against a runtime key Barrett's 4), every word add
  2 operations at u64 (1 at u32);
- bytes through HBM: each input read once, each output written once.

The peaks (`Peaks`): the INT32 rate is SMs x 64 INT32 lanes x the maximum SM
clock, 1.673e13/s at 132 SMs and 1,980 MHz (NVIDIA H100 Tensor Core GPU
data sheet; Hopper architecture white paper, "H100 SM architecture": 64
INT32 units per SM); HBM3 3.35e12 B/s (the data sheet's H100 SXM).  The SM
count and clock are arguments (`Peaks`, `Peaks.of_device`): no counting
function here asks the card.

Each kernel's work is a function of its plan and shapes (``*_work``); its
bound is ``bound(*_work(...), peaks)``, the numbers ``chip_smoke.py``
prints.  `KERNEL_WORK` gives each kernel wrapper of `ops/pbs_kernel` its
work from its arguments: while `count_fn` runs, each wrapper is swapped for
one that counts that work, whether the kernel or its plain version ran,
and not the plain version's own torch ops (every caller looks a wrapper up
as ``pbs_kernel.<name>`` when it calls it); outside `count_fn` the
wrappers are untouched.  Every other torch op counts one INT32 operation
per output element (a reduction: per input element; the TPU package's
counter takes reductions as free), and the bytes of its inputs and
outputs.  Views and allocations are free.  There is no
compiled loop whose trip count would have to be read: every op runs and is
counted as it runs.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._pytree import tree_leaves

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
INT32_LANES_PER_SM = 64     # Hopper SM: 64 INT32 units (Hopper white paper)
SHOUP_MULTIPLIES = 3        # one Shoup product: mulhi + two 32-bit multiplies
BARRETT_MULTIPLIES = 4      # a runtime-key product: mul, two mulhi, mul
CENTRED_SHOUP = 2           # a u64 word to one centred residue: two Shoup
U64_ADD_OPS = 2             # a u64 add as INT32 operations (a u32 add: 1)
SMEM_BYTES_PER_CLOCK = 128  # shared memory per SM and clock (Hopper)


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One card's peak rates: its SM count and its maximum SM clock (MHz;
    as ``nvidia-smi --query-gpu=clocks.max.sm`` gives it)."""
    sms: int
    max_clock_mhz: float

    @property
    def hbm_bytes_per_s(self) -> float:
        return HBM_BYTES_PER_S

    @property
    def int32_per_s(self) -> float:
        return self.sms * INT32_LANES_PER_SM * self.max_clock_mhz * 1e6

    @property
    def smem_bytes_per_s(self) -> float:
        return self.sms * SMEM_BYTES_PER_CLOCK * self.max_clock_mhz * 1e6

    @classmethod
    def of_device(cls, device, max_clock_mhz: float) -> "Peaks":
        """The SM count of CUDA ``device`` (asked once, here) at the given
        clock."""
        return cls(torch.cuda.get_device_properties(
            torch.device(device)).multi_processor_count, max_clock_mhz)


H100_SXM = Peaks(132, 1980.0)   # NVIDIA H100 80GB HBM3 at its maximum clock


def bound(work: dict, peaks: Peaks) -> dict:
    """``work`` ({"int32_ops", "bytes", ...}) with the least time the card
    needs for it: the larger of its INT32 operations over the INT32 rate
    and its bytes over HBM, in ms, and which of them binds."""
    rate = peaks.int32_per_s
    t_ops, t_bytes = work["int32_ops"] / rate, work["bytes"] / \
        peaks.hbm_bytes_per_s
    return {**work, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "int32_per_s": rate}


def butterflies(kp, rows):
    return rows * (kp.N // 2) * int(math.log2(kp.N))


def word_bytes(kp):
    """Bytes of one torus word at the plan's width (8 or 4)."""
    return kp.torus_bits // 8


def word_ops(kp):
    """INT32 operations of a word add, and Shoup products of a word's
    centred residue, at the plan's width: (2, 2) for u64, (1, 1) for u32."""
    return (U64_ADD_OPS, CENTRED_SHOUP) if kp.torus_bits == 64 else (1, 1)


# --- each kernel's work ------------------------------------------------------

def rot_twiddle_bytes(kp, rot_ntt):
    """Bytes of the rotation-free step's twiddle tables (psi's powers [P,
    2N] and the slots' exponents [N], u32), read once; 0 for the classic
    step."""
    return (2 * kp.P + 1) * kp.N * 4 if rot_ntt else 0


def rotation_work(kp, n, B, key_bytes, rot_ntt=False):
    """K1, an n-step rotation of B ciphertexts: per step and ciphertext J*P
    digit and C*P inverse NTTs (one Shoup product per butterfly), J*C*P*N
    key products and one Garner product per word, 3 multiplies each, and in
    the rotation-free step (``rot_ntt``) C*P*N twiddle products more (one
    table read per slot and prime, C products); bytes: the key
    (``key_bytes``) read once, the accumulators in and out, the exponents,
    the twiddle tables."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    mod_products = (butterflies(kp, J * P + C * P) + J * C * P * N + C * N
                    + (C * P * N if rot_ntt else 0))
    multiplies = SHOUP_MULTIPLIES * mod_products * n * B
    return {"int32_ops": multiplies, "multiplies": multiplies,
            "bytes": key_bytes + 2 * B * C * N * kp.torus_bits // 8
            + n * B * 4 + rot_twiddle_bytes(kp, rot_ntt),
            "mod_products_per_step": mod_products}


def step_work(kp, B, rot_ntt=False):
    """K1-step: K1's work over one step (one step's key rows and Shoup
    companions read once, acc in and out, the exponents)."""
    return rotation_work(kp, 1, B, 2 * kp.J * kp.C * kp.P * kp.N * 4,
                         rot_ntt)


def keyswitch_work(dig, ab):
    """K2's select-sum on these digits: one word add per nonzero digit and
    column (2 INT32 operations for a u64 word, 1 for a u32 word); bytes: the
    distinct table rows the digits select, read once, the digits, the
    output."""
    B, n_in, t = dig.shape
    base_m1, width = ab.shape[2], ab.shape[3]
    d = dig.to(torch.int64).reshape(B, n_in * t)
    nz = d != 0
    adds = int(nz.sum()) * width
    flat = torch.arange(n_in * t, device=d.device) * base_m1 + d - 1
    selected = torch.zeros(n_in * t * base_m1, dtype=torch.bool,
                           device=d.device)
    selected[flat[nz]] = True
    rows = int(selected.sum())
    w = ab.element_size()
    return {"word_adds": adds, "int32_ops": adds * w // 4,
            "bytes": rows * width * w + dig.numel() * dig.element_size()
            + B * width * w, "rows_selected": rows}


def apply_scan_work(kp, B, G, per_row):
    """K3, per ciphertext and step: J*P digit and C*P inverse NTTs (one
    Shoup product per butterfly), J*C*P*N Barrett products, one Garner
    product per output word; bytes: the keys read once, acc in and out."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    shoup = butterflies(kp, J * P + C * P) + C * N
    ops = (SHOUP_MULTIPLIES * shoup + BARRETT_MULTIPLIES * J * C * P * N) \
        * B * G
    return {"int32_ops": ops,
            "bytes": G * (B if per_row else 1) * J * C * P * N * 4
            + 2 * B * C * N * word_bytes(kp)}


def unfolded_work(kp, B, G, M):
    """K4, per ciphertext and group: J*P digit, J*C*P key and C*P inverse
    NTTs, J*C*P*N centred reductions (two Shoup products each) and Barrett
    products, J*C*N*M word rotate-adds, one Garner product per word; bytes:
    the key products read once, acc in and out, the exponents."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    add_ops, centred = word_ops(kp)
    shoup = (butterflies(kp, J * P + J * C * P + C * P)
             + centred * J * C * P * N + C * N)
    ops = (SHOUP_MULTIPLIES * shoup + BARRETT_MULTIPLIES * J * C * P * N
           + add_ops * J * C * N * M) * B * G
    return {"int32_ops": ops,
            "bytes": (G * M * J * C * N + 2 * B * C * N) * word_bytes(kp)
            + B * G * M * 4}


def ubr_phase1_work(kp, B, G, M):
    """K5 (and K5-v1), per ciphertext and group: J*C*P key NTTs, J*C*P*N
    centred reductions, J*C*N*M word rotate-adds; bytes: the key products
    read once, the exponents, the u32 output."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    add_ops, centred = word_ops(kp)
    shoup = butterflies(kp, J * C * P) + centred * J * C * P * N
    return {"int32_ops": (SHOUP_MULTIPLIES * shoup + add_ops * J * C * N * M)
            * B * G,
            "bytes": G * M * J * C * N * word_bytes(kp) + B * G * M * 4
            + B * G * J * C * P * N * 4}


def entry_bytes(kp_ks):
    """Bytes of one keyset entry [Jk, C, Pk, N] u32."""
    return (kp_ks.C - 1) * kp_ks.l * kp_ks.C * kp_ks.P * kp_ks.N * 4


def distinct_entry_bytes(kidx, kp_ks):
    """Bytes of the distinct keyset entries that these indices select."""
    return int(torch.unique(kidx).numel()) * entry_bytes(kp_ks)


def auto_ks_ops(kp_ks, B):
    """INT32 operations of B key switches (K6, K6-old): per ciphertext Jk*P
    digit and C*P inverse NTTs, Jk*C*P*N Barrett key products, one Garner
    product per word."""
    C, P, N = kp_ks.C, kp_ks.P, kp_ks.N
    Jk = (C - 1) * kp_ks.l
    shoup = butterflies(kp_ks, Jk * P + C * P) + C * N
    return (SHOUP_MULTIPLIES * shoup + BARRETT_MULTIPLIES * Jk * C * P * N) * B


def auto_ks_work(kp_ks, B, kidx):
    """K6: one key switch per ciphertext; bytes: the distinct keyset entries
    read once, the words in and out, kidx and ginv."""
    return {"int32_ops": auto_ks_ops(kp_ks, B),
            "bytes": distinct_entry_bytes(kidx, kp_ks)
            + 2 * B * kp_ks.C * kp_ks.N * word_bytes(kp_ks) + B * 8}


def auto_ks_gathered_work(kp_ks, B):
    """K6-old: K6's operations; bytes: the B gathered keyset rows (one entry
    per ciphertext, each an input read once), the words in and out."""
    return {"int32_ops": auto_ks_ops(kp_ks, B),
            "bytes": B * entry_bytes(kp_ks)
            + 2 * B * kp_ks.C * kp_ks.N * word_bytes(kp_ks)}


def cmux_delta_work(kp, B):
    """K1-delta for B ciphertexts: per ciphertext J*P digit and C*P inverse
    NTTs, J*C*P*N key products (counted as Shoup products: the function is
    given the key's Shoup companions, as K1's count takes them) and one
    Garner product per word; bytes: the TRGSW's residues read once (the
    companions need not move), the words in and out."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    shoup = butterflies(kp, J * P + C * P) + J * C * P * N + C * N
    return {"int32_ops": SHOUP_MULTIPLIES * shoup * B,
            "bytes": J * C * P * N * 4 + 2 * B * C * N * word_bytes(kp)}


def ga_work(kp, kp_ks, gens):
    """K7 over n steps and B ciphertexts (gens [n, B]).  Per step and
    ciphertext: the external product (J*P digit and C*P inverse NTTs,
    J*C*P*N Shoup key products, one Garner product per word), then the key
    switch (Jk*Pk digit and C*Pk inverse NTTs, Jk*C*Pk*N Barrett key
    products, Garner).  Bytes: the TRGSW keys and the distinct keyset
    entries these generators select, each read once, acc in and out, the
    generators.  Also the keyset bytes the blocks gather (one entry per
    ciphertext and step)."""
    n, B = gens.shape
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    Jk, Pk = (C - 1) * kp_ks.l, kp_ks.P
    shoup = (butterflies(kp, J * P + C * P) + J * C * P * N + C * N
             + butterflies(kp_ks, Jk * Pk + C * Pk) + C * N)
    barrett = Jk * C * Pk * N
    kidx = (gens.to(torch.int64) - 1) >> 1
    return {"int32_ops": (SHOUP_MULTIPLIES * shoup
                          + BARRETT_MULTIPLIES * barrett) * n * B,
            "bytes": 2 * n * J * C * P * N * 4
            + distinct_entry_bytes(kidx, kp_ks)
            + 2 * B * C * N * word_bytes(kp) + n * B * 4,
            "gathered_bytes": n * B * entry_bytes(kp_ks),
            "products_per_step": shoup + barrett}


def partial_step_work(kp, B, j_local, rot_ntt=False):
    """K8a for B ciphertexts over j_local key rows: per ciphertext j_local*P
    digit NTTs and j_local*C*P*N key products (counted as Shoup products, as
    K1's count takes them), and C*P*N twiddle products in the rotation-free
    step; bytes: acc in, the exponents, the key rows' residues (the Shoup
    companions need not move), the partial out, the twiddle tables."""
    C, P, N = kp.C, kp.P, kp.N
    shoup = (butterflies(kp, j_local * P) + j_local * C * P * N
             + (C * P * N if rot_ntt else 0))
    return {"int32_ops": SHOUP_MULTIPLIES * shoup * B,
            "bytes": B * C * N * word_bytes(kp) + B * 4
            + j_local * C * P * N * 4 + B * C * P * N * 4
            + rot_twiddle_bytes(kp, rot_ntt),
            "products_per_ciphertext": shoup}


def finish_step_work(kp, B, m):
    """K8b for B ciphertexts on m partials: per ciphertext C*P inverse NTTs
    and one Garner product per word; bytes: the m partials in, acc in and
    out."""
    C, P, N = kp.C, kp.P, kp.N
    shoup = butterflies(kp, C * P) + C * N
    return {"int32_ops": SHOUP_MULTIPLIES * shoup * B,
            "bytes": m * B * C * P * N * 4 + 2 * B * C * N * word_bytes(kp),
            "products_per_ciphertext": shoup}


# --- shared memory ---------------------------------------------------------

def smem_ms(nbytes, peaks: Peaks):
    """Milliseconds to read ``nbytes`` from shared memory at
    SMEM_BYTES_PER_CLOCK per SM and clock: a ceiling derived from a
    design, not a measurement."""
    return 1e3 * nbytes / peaks.smem_bytes_per_s


def smem_ceiling_ms(kp, B, G, M, peaks: Peaks):
    """K5's shared-memory ceiling, derived from its design, not measured:
    each staged rotate-add reads one word of shared memory (8 B, 4 at the
    32-bit torus), B G M J C N of them."""
    return smem_ms(B * G * M * kp.J * kp.C * kp.N * word_bytes(kp), peaks)


# --- counting a call ---------------------------------------------------------

@dataclasses.dataclass
class Counts:
    """Work of a call: INT32 operations and HBM bytes in all, and the part
    of them done by each kernel wrapper (``kernels``: name -> Counts, with
    ``launches`` the wrapper's calls)."""
    int32_ops: float = 0.0
    hbm_bytes: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)
    launches: int = 0

    def __add__(self, o):
        ks = dict(self.kernels)
        for name, c in o.kernels.items():
            ks[name] = ks[name] + c if name in ks else c
        return Counts(self.int32_ops + o.int32_ops,
                      self.hbm_bytes + o.hbm_bytes, ks,
                      self.launches + o.launches)

    def __mul__(self, s):
        return Counts(self.int32_ops * s, self.hbm_bytes * s,
                      {name: c * s for name, c in self.kernels.items()},
                      self.launches)

    @property
    def glue(self) -> "Counts":
        """What the torch ops outside the kernel wrappers did."""
        return Counts(
            self.int32_ops - sum(c.int32_ops for c in self.kernels.values()),
            self.hbm_bytes - sum(c.hbm_bytes for c in self.kernels.values()))


def _touched_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor (a view, perhaps broadcast) spans:
    dimensions of stride 0 read the same element again."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _flat_tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


# ops that move or make no element, besides views: allocations and aliases
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense"}


class _Counter:
    """The state of one `count_fn`: the counts so far, and the depth of
    kernel wrappers the current op runs inside (their ops are not counted:
    the wrapper's work is)."""

    def __init__(self):
        self.counts = Counts()
        self.kernel_depth = 0

    def op(self, func, args, kwargs, out):
        if self.kernel_depth:
            return
        name = func._schema.name.split("::")[-1]
        if getattr(func, "is_view", False) or name in _FREE:
            return
        ins = _flat_tensors((args, kwargs))
        outs = _flat_tensors(out)
        if torch.Tag.reduction in func.tags:          # per input element
            ops = ins[0].numel() if ins else 0
        else:
            ops = sum(t.numel() for t in outs)
        self.counts.int32_ops += ops
        self.counts.hbm_bytes += (sum(_touched_bytes(t) for t in ins)
                                  + sum(_touched_bytes(t) for t in outs))

    def kernel(self, name, work):
        c = Counts(work["int32_ops"], work["bytes"], launches=1)
        self.counts.int32_ops += c.int32_ops
        self.counts.hbm_bytes += c.hbm_bytes
        ks = self.counts.kernels
        ks[name] = ks[name] + c if name in ks else c


# each kernel wrapper of `ops/pbs_kernel`: its work from its arguments
KERNEL_WORK = {
    "blind_rotate_scan": lambda acc0, a_int, keyv, keyvs, kp, rot_ntt=False:
        rotation_work(kp, a_int.shape[0], acc0.shape[0],
                      (keyv.numel() + keyvs.numel()) * 4, rot_ntt),
    "pbs_step": lambda acc, a, keyv, keyvs, kp, rot_ntt=False: step_work(
        kp, acc.shape[0], rot_ntt),
    "tlwe_keyswitch_sum": keyswitch_work,
    "ext_product_apply_scan": lambda acc0, sa32, kp, per_row=False:
        apply_scan_work(kp, acc0.shape[0], sa32.shape[0], per_row),
    "ext_product_apply_step": lambda acc, key32, kp, per_row=False:
        apply_scan_work(kp, acc.shape[0], 1, per_row),
    "unfolded_rotate": lambda acc0, rot, su, kp: unfolded_work(
        kp, *rot.shape),
    "ubr_phase1_combine": lambda su, rot, kp: ubr_phase1_work(kp, *rot.shape),
    "ubr_phase1_combine_v1": lambda su, rot, kp: ubr_phase1_work(
        kp, *rot.shape),
    "auto_keyswitch_stream": lambda x, ak32, kidx, ginv, kp: auto_ks_work(
        kp, x.shape[0], kidx),
    "auto_keyswitch": lambda perm, key_rows, kp: auto_ks_gathered_work(
        kp, perm.shape[0]),
    "cmux_delta": lambda x, keyv, keyvs, kp: cmux_delta_work(kp, x.shape[0]),
    "ga_scan_fused": lambda acc0, gens, sv32, svs32, ak32, inv2n, kp, kp_ks:
        ga_work(kp, kp_ks, gens),
    "partial_step": lambda acc, a, j0, keyv, keyvs, kp, out=None,
        rot_ntt=False: partial_step_work(kp, acc.shape[0], keyv.shape[0],
                                         rot_ntt),
    "finish_step": lambda acc, parts, kp: finish_step_work(
        kp, acc.shape[0], parts.shape[0]),
}


class _Counted:
    """Kernel wrapper ``fn`` while a `count_fn` runs: a call adds ``work``'s
    count and none of the torch ops it runs (its plain version's on CPU
    tensors); a wrapper called inside another counts nothing more.  Its
    ``launches`` is ``fn``'s, which the wrapper adds to by its own name."""

    def __init__(self, fn, work, counter):
        self.__wrapped__, self.__name__ = fn, fn.__name__
        self._work, self._counter = work, counter

    def __call__(self, *args, **kwargs):
        c = self._counter
        c.kernel_depth += 1
        try:
            if c.kernel_depth == 1:
                c.kernel(self.__name__, self._work(*args, **kwargs))
            return self.__wrapped__(*args, **kwargs)
        finally:
            c.kernel_depth -= 1

    launches = property(
        lambda self: self.__wrapped__.launches,
        lambda self, n: setattr(self.__wrapped__, "launches", n))


def count_fn(fn, *args, **kwargs) -> Counts:
    """Counts of ``fn(*args, **kwargs)``, run once, on whatever device its
    inputs are (the kernels' work by `KERNEL_WORK`, every other torch op as
    it runs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..ops import pbs_kernel as pk

    counter = _Counter()

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            counter.op(func, args, kwargs or {}, out)
            return out

    saved = {name: getattr(pk, name) for name in KERNEL_WORK}
    if any(isinstance(w, _Counted) for w in saved.values()):
        raise RuntimeError("count_fn does not nest")
    for name, work in KERNEL_WORK.items():
        setattr(pk, name, _Counted(saved[name], work, counter))
    try:
        with _Mode():
            fn(*args, **kwargs)
    finally:
        for name, w in saved.items():
            setattr(pk, name, w)
    return counter.counts


def count_pbs(p, batch: int, torus_base: int = 4, unfolding: int = 1,
              device=None) -> Counts:
    """Per-bootstrap counts of `bootstrap.functional_bootstrap` at parameter
    set ``p`` on ``batch`` ciphertexts, run once on ``device`` (the CUDA
    card unless named) with keys made here from a fixed seed."""
    from .. import bootstrap, rng, tlwe, trgsw, trlwe
    from .._device import default_device
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    key_tlwe = tlwe.new_binary_key(p.n, p.lwe_sigma, gen, dev)
    key_trlwe = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    bk = bootstrap.new_key(trgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe,
                           gen, dev, unfolding)
    tv = trlwe.torus_packing(rng.uniform_torus(gen, (4,), dev), p.k, p.N)
    cs = tlwe.encrypt(rng.uniform_torus(gen, (batch,), dev), key_tlwe, gen)
    c = count_fn(bootstrap.functional_bootstrap, tv, cs, bk, torus_base)
    return c * (1.0 / batch)


def report(counts: Counts, seconds: float, peaks: Peaks = H100_SXM) -> dict:
    """The call's share of the card's speed of light, per resource, and the
    binding one (the TPU package's report, named for this card).

    ``mfu`` = time the binding resource needs at its peak over ``seconds``;
    ``sol_ms`` that least time; ``mfu_int32`` and ``hbm_frac`` each
    resource's share; ``int32_gop`` and ``hbm_mib`` the counts."""
    t_int = counts.int32_ops / peaks.int32_per_s
    t_hbm = counts.hbm_bytes / peaks.hbm_bytes_per_s
    which, t_bound = max((("int32", t_int), ("hbm", t_hbm)),
                         key=lambda kv: kv[1])
    return {"mfu": t_bound / seconds, "bound": which,
            "mfu_int32": t_int / seconds, "hbm_frac": t_hbm / seconds,
            "sol_ms": t_bound * 1e3, "int32_gop": counts.int32_ops / 1e9,
            "hbm_mib": counts.hbm_bytes / 2**20}

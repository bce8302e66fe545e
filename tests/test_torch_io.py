"""The port's `io` against the TPU package's, bit for bit, on the CPU:

- the versioned container both ways for every registered type at TOY and
  TOY_K2: a file the TPU package saved loads in the port equal to
  `bridge`'s conversion of the same arrays, and a file the port saved
  loads in the TPU package equal to the original, dtypes and static
  fields included; the version-1 layout of an unfolded key;
- every file under `tests/vectors/` (written by the reference C library)
  imported by both packages: the same words, keys and residues, DFT
  layouts included; every export byte-identical to the TPU package's
  export of the same object;
- the reference's unfolded bootstrap key (vec2) bootstrapping the
  reference's input on the port's plain path: the TPU package's words,
  within 2^36 of the reference's own output phase;
- ufhe's keysets, context and integers saved and loaded by the port, the
  loaded keyset decrypting.

The TPU side runs only its numpy import/export and save/load code; the
NTT steps inside its DFT importers and exporters are jitted here (the
same integer arithmetic as its eager calls, which take ~10 s per shape to
dispatch), and one bootstrap is jitted."""

import inspect
import io as pyio
import json
import os
import zipfile
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap as jbs, io as jio, native as jnative, \
    ntt as jntt, params as jparams, seeded as jseeded, trlwe as jtrlwe
from mosfhet_tpu.torus import double2torus as jdouble2torus
from mosfhet_torch import bootstrap as tbs, bridge, io as tio, native, \
    ntt as tntt, params as tparams, seeded as tseeded, tlwe as ttlwe, \
    torus as ttorus, trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.apps import ufhe as tufhe
from mosfhet_torch.bridge import to_numpy

CPU = "cpu"
VEC = os.path.join(os.path.dirname(__file__), "vectors")
AES_KEY = bytes(range(1, 17))     # the vaes vectors' process key


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jit_tpu_ntt():
    """The TPU package's NTT steps, jitted per plan, in place of its eager
    calls inside `io` (module attributes looked up at call time)."""
    names = ("to_ntt_u64", "inverse_ntt", "garner_u64")
    orig = {name: getattr(jntt, name) for name in names}
    cache = {}

    def wrap(name):
        def call(x, plan):
            key = (name, plan.N, tuple(plan.primes))
            if key not in cache:
                cache[key] = jax.jit(lambda y: orig[name](y, plan))
            return cache[key](x)
        return call

    mp = pytest.MonkeyPatch()
    for name in names:
        mp.setattr(jntt, name, wrap(name))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tpu_native_plain():
    """The TPU package's mask expansions through its plain numpy and
    hashlib versions (so its side neither builds nor reads a library);
    AES, which it has only in the library, through the port's (held to
    FIPS-197 and to the vaes sample's decryption in
    tests/test_torch_native.py)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_load", lambda: None)
    mp.setattr(jnative, "aes128_ctr_le", native.aes128_ctr_le)
    yield
    mp.undo()


def _public(mod) -> set:
    """The names a module defines for its users: its public functions,
    classes and constants, not what it imports."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and n != "annotations"
            and not inspect.ismodule(v)
            and not (callable(v) and getattr(v, "__module__", mod.__name__)
                     != mod.__name__)}


def test_port_modules_have_the_tpu_names():
    from mosfhet_tpu import refrng as jrefrng
    from mosfhet_torch import refrng as trefrng
    for jmod, tmod in ((jio, tio), (jnative, native), (jrefrng, trefrng),
                       (jseeded, tseeded)):
        assert _public(jmod), jmod
        assert _public(jmod) - set(vars(tmod)) == set(), tmod


# --- random objects of every registered type, both packages ----------------

def _words(rs, shape):
    return rs.integers(0, 1 << 64, shape, dtype=np.uint64)


def _bits(rs, shape):
    return rs.integers(0, 2, shape, dtype=np.int64)


def _res(rs, shape, primes):
    """Canonical residues u64 [..., P, N]."""
    return rs.integers(0, 1 << 62, shape, dtype=np.uint64) \
        % np.array(primes, np.uint64)[:, None]


def _shoup(v, primes):
    return (v << np.uint64(32)) // np.array(primes, np.uint64)[:, None]


def _seeds(rs, shape):
    return rs.integers(0, 1 << 32, shape + (2,), dtype=np.uint64).astype(
        np.uint32)


def _jax(name, **fields):
    """The TPU package's object of type ``name`` from numpy or nested
    fields."""
    cls = jio._registry()[name]
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in fields.items()})


class _Spec:
    """Random fields of one type at one parameter set: ``jax`` the TPU
    package's object, ``port`` `bridge`'s conversion of the same arrays."""

    def __init__(self, name: str, p_name: str):
        self.p = jparams.PARAM_REGISTRY[p_name]
        self.tp = tparams.PARAM_REGISTRY[p_name]
        p = self.p
        self.rs = np.random.default_rng(
            zlib.crc32(f"{name}/{p_name}".encode()))
        self.primes = tntt.primes_for_bound(
            tntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
        self.C, self.R = p.k + 1, (p.k + 1) * p.l
        self.bm1 = (1 << p.base_bit) - 1
        self.jax, self.port = getattr(self, name)()

    # leaves
    def TLWE(self, batch=(3,)):
        a, b = _words(self.rs, batch + (self.p.n,)), _words(self.rs, batch)
        return (_jax("TLWE", a=a, b=b), bridge.tlwe_from_numpy(a, b, CPU))

    def TLWEKey(self):
        s = _bits(self.rs, (self.p.n,))
        return (_jax("TLWEKey", s=s, sigma=self.p.lwe_sigma),
                bridge.tlwe_key_from_numpy(s, self.p.lwe_sigma, CPU))

    def _ks_ab(self, shape):
        return _words(self.rs, shape + (self.p.n,)), _words(self.rs, shape)

    def TLWEKSKey(self):
        p = self.p
        a, b = self._ks_ab((8, p.t, self.bm1))
        return (_jax("TLWEKSKey", a=a, b=b, t=p.t, base_bit=p.base_bit),
                bridge.tlwe_ks_key_from_numpy(a, b, p.t, p.base_bit, CPU))

    def TLWEKSKeyM(self):
        p = self.p
        a, b = self._ks_ab((8, p.t))
        return (_jax("TLWEKSKeyM", a=a, b=b, t=p.t, base_bit=p.base_bit),
                bridge.tlwe_ks_key_m_from_numpy(a, b, p.t, p.base_bit, CPU))

    def TLWEKSKeyPrepared(self):
        p = self.p
        a = self.rs.integers(-8, 8, (16, 8 * p.t, p.n), dtype=np.int8)
        b = self.rs.integers(-8, 8, (16, 8 * p.t), dtype=np.int8)
        return (_jax("TLWEKSKeyPrepared", a_nib=a, b_nib=b, t=p.t,
                     base_bit=p.base_bit),
                bridge.tlwe_ks_key_prepared_from_numpy(a, b, p.t,
                                                       p.base_bit, CPU))

    def TRLWE(self, batch=(2,)):
        p = self.p
        a = _words(self.rs, batch + (p.k, p.N))
        b = _words(self.rs, batch + (p.N,))
        return (_jax("TRLWE", a=a, b=b), bridge.trlwe_from_numpy(a, b, CPU))

    def TRLWEKey(self):
        p = self.p
        s = _bits(self.rs, (p.k, p.N))
        return (_jax("TRLWEKey", s=s, sigma=p.rlwe_sigma, s_bound=1),
                bridge.trlwe_key_from_numpy(s, p.rlwe_sigma, 1, CPU))

    def TRLWEDFT(self):
        v = _res(self.rs, (2, self.C, len(self.primes), self.p.N),
                 self.primes)
        vs = _shoup(v, self.primes)
        return (_jax("TRLWEDFT", v=v, vs=vs, primes=self.primes),
                bridge.trlwe_dft_from_numpy(v, vs, self.primes, CPU))

    def TRGSW(self):
        p = self.p
        rows = _words(self.rs, (self.R, self.C, p.N))
        return (_jax("TRGSW", rows=rows, l=p.l, Bg_bit=p.Bg_bit),
                bridge.trgsw_from_numpy(rows, p.l, p.Bg_bit, CPU))

    def TRGSWDFT(self, with_shoup=False):
        p = self.p
        v = _res(self.rs, (self.R, self.C, len(self.primes), p.N),
                 self.primes)
        vs = _shoup(v, self.primes) if with_shoup else None
        return (_jax("TRGSWDFT", v=v, vs=vs, l=p.l, Bg_bit=p.Bg_bit,
                     primes=self.primes),
                bridge.trgsw_dft_from_numpy(v, vs, p.l, p.Bg_bit,
                                            self.primes, CPU))

    def TRGSWKey(self):
        jk, tk = self.TRLWEKey()
        p = self.p
        return (_jax("TRGSWKey", trlwe_key=jk, l=p.l, Bg_bit=p.Bg_bit),
                ttrgsw.new_key(tk, p.l, p.Bg_bit))

    def TRGSWReg(self):
        (jp, tp), (jn, tn) = self.TRGSWDFT(True), self.TRGSWDFT(True)
        return (_jax("TRGSWReg", positive=jp, negative=jn),
                ttrgsw.TRGSWReg(positive=tp, negative=tn))

    def TRLWEKSKey(self):
        p = self.p
        v = _res(self.rs, (p.k, p.t, self.C, len(self.primes), p.N),
                 self.primes)
        return (_jax("TRLWEKSKey", v=v, vs=_shoup(v, self.primes), t=p.t,
                     base_bit=p.base_bit, primes=self.primes),
                bridge.trlwe_ks_key_from_numpy(v, p.t, p.base_bit,
                                               self.primes, CPU))

    def GenericKSKey(self):
        p = self.p
        tab = _words(self.rs, (p.n + 1, p.t, self.bm1, self.C, p.N))
        return (_jax("GenericKSKey", table=tab, t=p.t, base_bit=p.base_bit,
                     include_b=True),
                bridge.generic_ks_key_from_numpy(tab, p.t, p.base_bit, True,
                                                 CPU))

    def LUTPackingKSKey(self, rows=2):
        p = self.p
        tab = _words(self.rs, (rows, 4, p.t, self.bm1, self.C, p.N))
        return (_jax("LUTPackingKSKey", table=tab, t=p.t,
                     base_bit=p.base_bit, torus_base=4),
                bridge.lut_packing_ks_key_from_numpy(tab, p.t, p.base_bit, 4,
                                                     CPU))

    def FullPackingKSKey(self):
        p = self.p
        v = _res(self.rs, (p.n, p.t, self.C, len(self.primes), p.N),
                 self.primes)
        vs = _shoup(v, self.primes)
        return (_jax("FullPackingKSKey", v=v, vs=vs, t=p.t,
                     base_bit=p.base_bit, primes=self.primes),
                bridge.full_packing_ks_key_from_numpy(v, vs, p.t, p.base_bit,
                                                      self.primes, CPU))

    def SeededGenericKSKey(self):
        p = self.p
        shape = (p.n, p.t, self.bm1)
        seeds, b = _seeds(self.rs, shape), _words(self.rs, shape + (p.N,))
        return (_jax("SeededGenericKSKey", seeds=seeds, b=b, k=p.k, t=p.t,
                     base_bit=p.base_bit, include_b=False),
                bridge.seeded_generic_ks_key_from_numpy(
                    seeds, b, p.k, p.t, p.base_bit, False, CPU))

    def SeededLUTPackingKSKey(self):
        p = self.p
        shape = (2, 4, p.t, self.bm1)
        seeds, b = _seeds(self.rs, shape), _words(self.rs, shape + (p.N,))
        return (_jax("SeededLUTPackingKSKey", seeds=seeds, b=b, k=p.k,
                     t=p.t, base_bit=p.base_bit, torus_base=4),
                bridge.seeded_lut_packing_ks_key_from_numpy(
                    seeds, b, p.k, p.t, p.base_bit, 4, CPU))

    def SeededTRLWEKSKey(self):
        p = self.p
        seeds = _seeds(self.rs, (p.k, p.t))
        b_v = _res(self.rs, (p.k, p.t, len(self.primes), p.N), self.primes)
        return (_jax("SeededTRLWEKSKey", seeds=seeds, b_v=b_v,
                     b_vs=_shoup(b_v, self.primes), k_out=p.k, t=p.t,
                     base_bit=p.base_bit, primes=self.primes),
                bridge.seeded_trlwe_ks_key_from_numpy(
                    seeds, b_v, p.k, p.t, p.base_bit, self.primes, CPU))

    def _bk_shape(self):
        p = self.p
        return dict(n=p.n, k=p.k, N=p.N, l=p.l, Bg_bit=p.Bg_bit)

    def BootstrapKey(self):
        p = self.p
        v = _res(self.rs, (p.n, self.R, self.C, len(self.primes), p.N),
                 self.primes)
        vs = _shoup(v, self.primes)
        return (_jax("BootstrapKey", v=v, vs=vs, su=None, unfolding=1,
                     primes=self.primes, **self._bk_shape()),
                bridge.bootstrap_key_from_numpy(
                    v, vs, *self._bk_shape().values(), self.primes, CPU))

    def BootstrapKey_u2(self):
        p = self.p
        su = _words(self.rs, (p.n // 2, 4, self.R, self.C, p.N))
        planes = np.stack([su & np.uint64(0xFFFFFFFF),
                           su >> np.uint64(32)]).astype(np.uint32)
        return (_jax("BootstrapKey", v=None, vs=None, su=planes,
                     unfolding=2, primes=self.primes, **self._bk_shape()),
                bridge.unfolded_bootstrap_key_from_numpy(
                    planes, *self._bk_shape().values(), self.primes, 2, CPU))

    def GABootstrapKey(self):
        p = self.p
        s_v = _res(self.rs, (p.n, self.R, self.C, len(self.primes), p.N),
                   self.primes)
        s_vs = _shoup(s_v, self.primes)
        ak_v = _res(self.rs, (p.N, p.k * p.l, self.C, len(self.primes), p.N),
                    self.primes)
        inv2n = self.rs.integers(0, 2 * p.N, p.N).astype(np.int32)
        shape = self._bk_shape()
        return (_jax("GABootstrapKey", s_v=s_v, s_vs=s_vs, ak_v=ak_v,
                     ak_vs=_shoup(ak_v, self.primes), inv2n=inv2n,
                     ks_t=p.l, ks_base_bit=p.Bg_bit, primes=self.primes,
                     ks_primes=self.primes, **shape),
                bridge.ga_bootstrap_key_from_numpy(
                    s_v, s_vs, ak_v, inv2n, *shape.values(), p.l, p.Bg_bit,
                    self.primes, self.primes, CPU))

    def SeededTRLWE(self):
        seed, b = _seeds(self.rs, (3,)), _words(self.rs, (3, self.p.N))
        return (_jax("SeededTRLWE", seed=seed, b=b, k=self.p.k),
                bridge.seeded_trlwe_from_numpy(seed, b, self.p.k, CPU))

    def MosfhetSeededTRLWE(self):
        seed = self.rs.integers(0, 256, (3, 16), dtype=np.uint8)
        b = _words(self.rs, (3, self.p.N))
        return (_jax("MosfhetSeededTRLWE", seed=seed, b=b, k=self.p.k,
                     prng="shake"),
                bridge.mosfhet_seeded_trlwe_from_numpy(seed, b, self.p.k,
                                                       "shake", CPU))

    # the ufhe keysets
    def TFHEParams(self):
        return self.p, self.tp

    def PrivKeyset(self):
        p = self.p
        s, rs_ = _bits(self.rs, (p.n,)), _bits(self.rs, (p.k, p.N))
        jt = _jax("TLWEKey", s=s, sigma=p.lwe_sigma)
        jr = _jax("TRLWEKey", s=rs_, sigma=p.rlwe_sigma, s_bound=1)
        je = _jax("TLWEKey", s=rs_.reshape(-1), sigma=p.lwe_sigma)
        jg = _jax("TRGSWKey", trlwe_key=jr, l=p.l, Bg_bit=p.Bg_bit)
        return (_jax("PrivKeyset", tlwe=jt, trlwe=jr, extracted=je,
                     trgsw=jg, params=p),
                bridge.ufhe_priv_keyset_from_numpy(s, rs_, self.tp, 1, CPU))

    def PublicKeyset(self):
        (jb, tb), (jp, tp), (jk, tk) = (self.BootstrapKey(),
                                        self.LUTPackingKSKey(),
                                        self.TLWEKSKey())
        return (_jax("PublicKeyset", bootstrap_key=jb, packing_key=jp,
                     ks_key=jk, params=self.p),
                tufhe.PublicKeyset(tb, tp, tk, self.tp))

    def Context(self):
        jks, tks = self.PublicKeyset()
        p = self.p
        luts = [_words(self.rs, s) for s in ((p.k, p.N), (p.N,)) * 2]
        tb = 4
        mulmod = tuple(tuple((i * j) % tb for j in range(tb))
                       for i in range(tb))
        mulquo = tuple(tuple((i * j) // tb for j in range(tb))
                       for i in range(tb))
        return (_jax("Context", keyset=jks,
                     addsub_lut=_jax("TRLWE", a=luts[0], b=luts[1]),
                     signextend_lut=_jax("TRLWE", a=luts[2], b=luts[3]),
                     torus_base=tb, log_torus_base=2, mulmod=mulmod,
                     mulquo=mulquo),
                bridge.ufhe_context_from_numpy(tks, *luts, tb))

    def Integer(self):
        jd, td = self.TLWE((2, 3))
        return (_jax("Integer", digits=jd, signed=True),
                tufhe.Integer(digits=td, signed=True))


SPECS = sorted(n for n in vars(_Spec) if n[0] != "_")


def test_specs_cover_the_registry():
    assert {n.split("_")[0] for n in SPECS} == set(jio._registry()) \
        == set(tio._registry())


def _port_leaves(obj, path="root"):
    """(path, dtype, numpy array) or (path, value) for every tensor and
    static field of a port object."""
    if isinstance(obj, torch.Tensor):
        yield path, str(obj.dtype), obj.detach().cpu().numpy()
    elif isinstance(obj, torch.nn.Module):
        for name, t in obj.state_dict(keep_vars=True).items():
            yield from _port_leaves(t, f"{path}.{name}")
        for mname, m in obj.named_modules():
            for k, v in sorted(vars(m).items()):
                if not k.startswith("_") and k != "training":
                    yield from _port_leaves(v, f"{path}.{mname}.{k}")
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            yield from _port_leaves(getattr(obj, k), f"{path}.{k}")
    elif isinstance(obj, (list, tuple)) and any(
            isinstance(x, torch.Tensor) for x in obj):
        for i, x in enumerate(obj):
            yield from _port_leaves(x, f"{path}[{i}]")
    else:
        yield path, repr(obj)


def _assert_port_equal(got, want):
    assert type(got) is type(want)
    g, w = list(_port_leaves(got)), list(_port_leaves(want))
    assert [x[:-1] if len(x) == 3 else x for x in g] == \
        [x[:-1] if len(x) == 3 else x for x in w]
    for a, b in zip(g, w):
        if len(a) == 3:
            np.testing.assert_array_equal(a[2], b[2], err_msg=a[0])


def _assert_tpu_equal(got, want):
    lg, tg = jax.tree_util.tree_flatten(got)
    lw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw, "treedef (static fields) differ"
    for a, b in zip(lg, lw):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("p_name", ["TOY", "TOY_K2"])
@pytest.mark.parametrize("name", SPECS)
def test_container_both_ways(name, p_name, tmp_path):
    """TPU save -> port load == bridge's conversion; port save -> TPU load
    == the original, dtypes and static fields included."""
    spec = _Spec(name, p_name)
    jio.save(tmp_path / "tpu.mtpu", spec.jax)
    _assert_port_equal(tio.load(tmp_path / "tpu.mtpu", device=CPU),
                       spec.port)
    tio.save(tmp_path / "port.mtpu", spec.port)
    _assert_tpu_equal(jio.load(tmp_path / "port.mtpu"), spec.jax)


def test_container_nested_and_checked(tmp_path):
    """Lists, tuples, dicts and None around objects; a foreign or newer
    file is refused."""
    spec = _Spec("TLWE", "TOY")
    obj = {"cts": [spec.port, None], "pair": (spec.port, 3), 1: "x"}
    tio.save(tmp_path / "n.mtpu", obj)
    back = tio.load(tmp_path / "n.mtpu", device=CPU)
    assert set(back) == {"cts", "pair", "1"}
    _assert_port_equal(back["cts"][0], spec.port)
    assert back["cts"][1] is None and back["pair"][1] == 3
    assert isinstance(back["pair"], tuple) and back["1"] == "x"
    tpu = jio.load(tmp_path / "n.mtpu")
    _assert_tpu_equal(tpu["pair"][0], spec.jax)
    for magic, version in (("other", 2), (tio.MAGIC, tio.VERSION + 1)):
        with zipfile.ZipFile(tmp_path / "bad.mtpu", "w") as z:
            z.writestr("manifest.json", json.dumps(
                {"magic": magic, "version": version,
                 "root": {"kind": "none"}}))
        with pytest.raises(ValueError):
            tio.load(tmp_path / "bad.mtpu", device=CPU)
    with pytest.raises(TypeError):
        tio.save(tmp_path / "x.mtpu", object())


def test_container_v1_unfolded_key(tmp_path):
    """A version-1 file holds an unfolded key's su as u64 words
    [n/u, 2^u, (k+1)l, k+1, N]: both packages load it as the v2 key."""
    spec = _Spec("BootstrapKey_u2", "TOY")
    su = np.asarray(spec.jax.su_u64())
    assert su.ndim == 5 and su.dtype == np.uint64
    v1 = jbs.BootstrapKey(v=None, vs=None, su=jnp.asarray(su),
                          n=spec.jax.n, k=spec.jax.k, N=spec.jax.N,
                          l=spec.jax.l, Bg_bit=spec.jax.Bg_bit, unfolding=2,
                          primes=spec.jax.primes)
    jio.save(tmp_path / "v2.mtpu", v1)
    with zipfile.ZipFile(tmp_path / "v2.mtpu") as z:
        files = {name: z.read(name) for name in z.namelist()}
    manifest = json.loads(files["manifest.json"])
    manifest["version"] = 1
    files["manifest.json"] = json.dumps(manifest).encode()
    with zipfile.ZipFile(tmp_path / "v1.mtpu", "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    _assert_port_equal(tio.load(tmp_path / "v1.mtpu", device=CPU), spec.port)
    _assert_tpu_equal(jio.load(tmp_path / "v1.mtpu"), spec.jax)


# --- the reference's files -------------------------------------------------

def _both(name, jfn, tfn):
    with open(os.path.join(VEC, name), "rb") as f:
        j = jfn(f)
    with open(os.path.join(VEC, name), "rb") as f:
        t = tfn(f)
    return j, t


def _same(port_tensor, tpu_array):
    """Port words (int64/int32 bits) == TPU words, as unsigned."""
    np.testing.assert_array_equal(to_numpy(port_tensor),
                                  np.asarray(tpu_array).astype(
                                      to_numpy(port_tensor).dtype))


def _check_tlwe_key(j, t):
    np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
    assert t.sigma == j.sigma


def _check_trlwe_key(j, t):
    _check_tlwe_key(j, t)
    assert t.s_bound == j.s_bound


def _check_ct(j, t):
    _same(t.a, j.a)
    _same(t.b, j.b)


def _samples(reader, count):
    return lambda f: [reader(f) for _ in range(count)]


def _check_cts(js, ts):
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        _check_ct(j, t)


def _check_bk_dft(j, t):
    assert (t.n, t.k, t.N, t.l, t.Bg_bit, t.unfolding, t.primes) == (
        j.n, j.k, j.N, j.l, j.Bg_bit, j.unfolding, tuple(j.primes))
    _same(t.v, j.v)
    _same(t.vs, j.vs)


def _check_bk_unfolded(j, t):
    assert (t.n, t.k, t.N, t.l, t.Bg_bit, t.unfolding, t.primes) == (
        j.n, j.k, j.N, j.l, j.Bg_bit, j.unfolding, tuple(j.primes))
    np.testing.assert_array_equal(bridge.unfolded_bootstrap_key_to_numpy(t),
                                  np.asarray(j.su))


def _check_trlwe_ks(j, t):
    assert (t.t, t.base_bit, t.primes) == (j.t, j.base_bit, tuple(j.primes))
    _same(t.v, j.v)


def _check_table(j, t):
    _same(t.table, j.table)
    for k in ("t", "base_bit", "include_b", "torus_base"):
        assert getattr(t, k, None) == getattr(j, k, None)


def _check_tlwe_ks(j, t):
    assert (t.t, t.base_bit) == (j.t, j.base_bit)
    _same(t.a, j.a)
    _same(t.b, j.b)


def _check_compressed(j, t):
    np.testing.assert_array_equal(t.seed.numpy(), np.asarray(j.seed))
    _same(t.b, j.b)
    assert (t.k, t.prng) == (j.k, j.prng)
    _check_ct(jseeded.expand_mosfhet(j), tseeded.expand_mosfhet(t))


def _reader(jfn, *args, **kw):
    """(TPU reader, port reader) of ``import_mosfhet_<jfn>`` with args."""
    name = "import_mosfhet_" + jfn
    return (lambda f: getattr(jio, name)(f, *args, **kw),
            lambda f: getattr(tio, name)(f, *args, **kw, device=CPU))


TK, RK = _reader("tlwe_key"), _reader("trlwe_key")


def _tlwes(n, count=1):
    jr, tr = _reader("tlwe", n)
    return _samples(jr, count), _samples(tr, count), _check_cts


def _trlwes(k, N, count=1, fn="trlwe", **kw):
    jr, tr = _reader(fn, k, N, **kw)
    return _samples(jr, count), _samples(tr, count), _check_cts


VECTORS = {
    # keys
    **{f: (*TK, _check_tlwe_key) for f in (
        "vec_tlwe_key.bin", "vec2_tlwe_key.bin", "v2_tlwe_key.bin",
        "v3_sp_tlwe_key.bin", "v3_replay_tlwe_key.bin")},
    **{f: (*RK, _check_trlwe_key) for f in (
        "vec_trlwe_key.bin", "vec2_trlwe_key.bin", "v2_trlwe_okey.bin",
        "v2_trlwe_ikey.bin", "v2_vaes_trlwe_key.bin", "v3_sp_trlwe_okey.bin",
        "v3_sp_trlwe_ikey.bin", "v3_replay_trlwe_key.bin")},
    # samples
    "vec_tlwe_sample.bin": _tlwes(32),
    "vec_tlwe_switched.bin": _tlwes(32),
    "vec_tlwe_big.bin": _tlwes(256),
    "vec2_input.bin": _tlwes(16),
    "vec2_output.bin": _tlwes(256),
    "v2_generic_in.bin": _tlwes(32),
    "v2_packing_in.bin": _tlwes(32, 4),
    "v3_replay_tlwe_samples.bin": _tlwes(32, 4),
    "v3_replay_bs_in.bin": _tlwes(32),
    "v3_replay_bs_out.bin": _tlwes(256),
    **{f: _trlwes(1, 256) for f in (
        "vec_trlwe_sample.bin", "v2_trlwe_ks_in.bin", "v2_trlwe_ks_out.bin",
        "v2_packing_out.bin", "v2_generic_out.bin", "v3_sp_trlwe_sample.bin",
        "v3_sp_trlwe_ks_out.bin", "v3_replay_trlwe_sample.bin")},
    "v3_sp_trlwe_dft_sample.bin": _trlwes(1, 256, fn="trlwe_dft",
                                          layout="spqlios"),
    "v2_vaes_compressed.bin": _trlwes(1, 256, fn="compressed_trlwe_vaes",
                                      aes_key=AES_KEY),
    "vec_trlwe_compressed.bin": (*_reader("compressed_trlwe", 1, 256,
                                          prng="shake"), _check_compressed),
    # key-switch and bootstrap keys
    "vec_tlwe_ks_key.bin": (*_reader("tlwe_ks_key"), _check_tlwe_ks),
    "vec2_bootstrap_key.bin": (*_reader("bootstrap_key"),
                               _check_bk_unfolded),
    "v2_bootstrap_key_u1.bin": (*_reader("bootstrap_key_dft"),
                                _check_bk_dft),
    "v3_replay_bootstrap_key.bin": (*_reader("bootstrap_key_dft"),
                                    _check_bk_dft),
    "v3_sp_bootstrap_key_u1.bin": (*_reader("bootstrap_key_dft",
                                            layout="spqlios"),
                                   _check_bk_dft),
    "v2_trlwe_ks_key.bin": (*_reader("trlwe_ks_key"), _check_trlwe_ks),
    "v3_sp_trlwe_ks_key.bin": (*_reader("trlwe_ks_key", layout="spqlios"),
                               _check_trlwe_ks),
    "v2_packing_ks_key.bin": (*_reader("packing_ks_key", prng="shake"),
                              _check_table),
    "v2_generic_ks_key.bin": (*_reader("generic_ks_key", prng="shake"),
                              _check_table),
}


def _probe_readers(layout, N):
    """A probe file holds N torus words and their DFT: both conversions
    of each package."""
    def reader(mod):
        def read(f):
            raw = f.read()
            p = np.frombuffer(raw[:N * 8], dtype="<u8")
            d = np.frombuffer(raw[N * 8:], dtype="<f8")
            return (mod.ffnt_dft_to_torus(d, layout),
                    mod.torus_to_ffnt_dft(p, layout))
        return read

    def check(j, t):
        for x, y in zip(j, t):
            np.testing.assert_array_equal(x, y)
    return reader(jio), reader(tio), check


VECTORS.update({f"v2_dft_probe{i}.bin": _probe_readers("ffnt", 256)
                for i in range(4)})
VECTORS.update({f"v3_sp_probe{i}_N{N}.bin": _probe_readers("spqlios", N)
                for i in range(4) for N in (256, 2048)})
# read by RefStream (tests/test_torch_native.py), not by an importer
REPLAY_ONLY = ("v3_replay_stream.bin", "v3_replay_normal.bin")


def test_vectors_cover_the_directory():
    files = {f for f in os.listdir(VEC) if f.endswith(".bin")}
    assert files == set(VECTORS) | set(REPLAY_ONLY)


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_reference_file_imports_like_tpu(name, jit_tpu_ntt, tpu_native_plain):
    jfn, tfn, check = VECTORS[name]
    j, t = _both(name, jfn, tfn)
    check(j, t)


# --- exports ---------------------------------------------------------------

def _export_cases():
    """name -> (TPU object, port object, exporter name, kwargs)."""
    jt, tt = _both("vec_tlwe_key.bin", *TK)
    jr, tr = _both("v2_trlwe_okey.bin", *RK)
    cases = {"tlwe_key": (jt, tt, "tlwe_key", {}),
             "trlwe_key": (jr, tr, "trlwe_key", {})}
    for name, spec, fn in (("tlwe", ("TLWE", "TOY"), "tlwe"),
                           ("trlwe", ("TRLWE", "TOY_K2"), "trlwe"),
                           ("trgsw", ("TRGSW", "TOY_K2"), "trgsw"),
                           ("tlwe_ks_key", ("TLWEKSKey", "TOY"),
                            "tlwe_ks_key"),
                           ("packing_ks_key", ("LUTPackingKSKey", "TOY_K2"),
                            "packing_ks_key"),
                           ("generic_ks_key", ("GenericKSKey", "TOY"),
                            "generic_ks_key"),
                           ("bootstrap_key_u2", ("BootstrapKey_u2", "TOY"),
                            "bootstrap_key")):
        s = _Spec(*spec)
        j, t = s.jax, s.port
        if name in ("tlwe", "trlwe"):       # one unbatched sample
            j = type(j)(a=j.a[0], b=j.b[0])
            t = type(t)(a=t.a[0], b=t.b[0])
        cases[name] = (j, t, fn, {})
    s = _Spec("TRLWE", "TOY")
    for layout in ("ffnt", "spqlios"):
        cases[f"trlwe_dft_{layout}"] = (
            type(s.jax)(a=s.jax.a[0], b=s.jax.b[0]),
            type(s.port)(a=s.port.a[0], b=s.port.b[0]), "trlwe_dft",
            {"layout": layout})
    # keys in NTT form need residues of real words: the TPU package's
    # exporters run them back through the inverse NTT and Garner
    rs = np.random.default_rng(7)
    p = jparams.TOY
    primes = tntt.primes_for_bound(
        tntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    plan = tntt.get_plan(p.N, primes, CPU)
    rows = _words(rs, (p.n, (p.k + 1) * p.l, p.k + 1, p.N))
    v = tntt.to_ntt_u64(bridge.to_tensor(rows, CPU), plan)
    vs = tntt.make_shoup(v, plan.p[:, None])
    vn, vsn = to_numpy(v), to_numpy(vs)
    bk_j = jbs.BootstrapKey(v=jnp.asarray(vn), vs=jnp.asarray(vsn), su=None,
                            n=p.n, k=p.k, N=p.N, l=p.l, Bg_bit=p.Bg_bit,
                            unfolding=1, primes=primes)
    bk_t = bridge.bootstrap_key_from_numpy(vn, vsn, p.n, p.k, p.N, p.l,
                                           p.Bg_bit, primes, CPU)
    kr = _words(rs, (p.k, p.t, p.k + 1, p.N))
    ks_primes = tntt.primes_for_bound(
        tntt.conv_bound(p.N, 1 << (p.base_bit - 1), p.k * p.t))
    ks_plan = tntt.get_plan(p.N, ks_primes, CPU)
    kv = to_numpy(tntt.to_ntt_u64(bridge.to_tensor(kr, CPU), ks_plan))
    ks_j = _jax("TRLWEKSKey", v=kv, vs=_shoup(kv, ks_primes), t=p.t,
                base_bit=p.base_bit, primes=ks_primes)
    ks_t = bridge.trlwe_ks_key_from_numpy(kv, p.t, p.base_bit, ks_primes, CPU)
    for layout in ("ffnt", "spqlios"):
        cases[f"bootstrap_key_u1_{layout}"] = (bk_j, bk_t, "bootstrap_key",
                                               {"layout": layout})
        cases[f"trlwe_ks_key_{layout}"] = (ks_j, ks_t, "trlwe_ks_key",
                                           {"layout": layout})
    return cases


EXPORTS = ("tlwe_key", "trlwe_key", "tlwe", "trlwe", "trgsw", "tlwe_ks_key",
           "packing_ks_key", "generic_ks_key", "bootstrap_key_u2",
           "trlwe_dft_ffnt", "trlwe_dft_spqlios", "bootstrap_key_u1_ffnt",
           "bootstrap_key_u1_spqlios", "trlwe_ks_key_ffnt",
           "trlwe_ks_key_spqlios")


@pytest.fixture(scope="module")
def export_cases():
    return _export_cases()


@pytest.mark.parametrize("name", EXPORTS)
def test_export_bytes_equal_tpu(name, export_cases, jit_tpu_ntt):
    j, t, fn, kw = export_cases[name]
    fj, ft = pyio.BytesIO(), pyio.BytesIO()
    getattr(jio, "export_mosfhet_" + fn)(fj, j, **kw)
    getattr(tio, "export_mosfhet_" + fn)(ft, t, **kw)
    assert len(ft.getvalue()) > 24
    assert ft.getvalue() == fj.getvalue()


def test_export_import_roundtrip_exact(export_cases):
    """Time-domain layouts and the u=2 key come back word for word; a DFT
    layout brings small key material back exactly."""
    for name, fn, args in (("tlwe_ks_key", "tlwe_ks_key", ()),
                           ("bootstrap_key_u2", "bootstrap_key", ()),
                           ("trgsw", "trgsw", (3, 8, 2, 64))):
        _, t, _, _ = export_cases[name]
        buf = pyio.BytesIO()
        getattr(tio, "export_mosfhet_" + fn)(buf, t)
        buf.seek(0)
        _assert_port_equal(getattr(tio, "import_mosfhet_" + fn)(
            buf, *args, device=CPU), t)
    rs = np.random.default_rng(3)
    small = rs.integers(-4, 5, (2, 256)).astype(np.int64).view(np.uint64)
    c = bridge.trlwe_from_numpy(small[:1], small[1], CPU)
    for layout in ("ffnt", "spqlios"):
        buf = pyio.BytesIO()
        tio.export_mosfhet_trlwe_dft(buf, c, layout)
        buf.seek(0)
        _assert_port_equal(tio.import_mosfhet_trlwe_dft(
            buf, 1, 256, layout, device=CPU), c)


def test_unfold1_key_is_refused_by_the_time_domain_reader():
    buf = pyio.BytesIO(np.array([4, 1, 1, 64, 9, 1], "<i4").tobytes())
    with pytest.raises(ValueError):
        tio.import_mosfhet_bootstrap_key(buf, device=CPU)


# --- the reference's unfolded key bootstrapping ------------------------------

def test_vec2_cross_bootstrap():
    """The reference's u=2 key (n=16, N=256, l=3, Bg_bit=9) and input
    through the port's plain path: the TPU package's words, within 2^36 of
    the reference's own output phase (its f64 FFT noise)."""
    def imp(mod, fn, name, *args, **kw):
        with open(os.path.join(VEC, name), "rb") as f:
            return getattr(mod, "import_mosfhet_" + fn)(f, *args, **kw)

    dev = {"device": CPU}
    tk = imp(tio, "tlwe_key", "vec2_tlwe_key.bin", **dev)
    rk = imp(tio, "trlwe_key", "vec2_trlwe_key.bin", **dev)
    bk = imp(tio, "bootstrap_key", "vec2_bootstrap_key.bin", **dev)
    c_in = imp(tio, "tlwe", "vec2_input.bin", tk.n, **dev)
    c_ref = imp(tio, "tlwe", "vec2_output.bin", rk.k * rk.N, **dev)
    lut = ttorus.double2torus(torch.arange(4, dtype=torch.float64) / 8.0,
                              CPU)
    tv = ttrlwe.torus_packing(lut, rk.k, rk.N)
    out = tbs.functional_bootstrap(tv, c_in, bk, 4)

    jbk = imp(jio, "bootstrap_key", "vec2_bootstrap_key.bin")
    jc = imp(jio, "tlwe", "vec2_input.bin", 16)
    jlut = jnp.stack([jdouble2torus(jnp.float64(i / 8.0)) for i in range(4)])
    jtv = jtrlwe.torus_packing(jlut, 1, 256)
    jout = jax.jit(lambda tv_, c_, bk_: jbs.functional_bootstrap(
        tv_, c_, bk_, 4))(jtv, jc, jbk)
    _same(out.a, jout.a)
    _same(out.b, jout.b)

    key_out = ttrlwe.extract_tlwe_key(rk)
    ph = int(ttlwe.phase(out, key_out))
    ph_ref = int(ttlwe.phase(c_ref, key_out))
    want = int(ttorus.double2torus(2 / 8.0, CPU))
    for x, y, bound in ((ph, want, 2**40), (ph_ref, want, 2**40),
                        (ph, ph_ref, 2**36)):
        d = (x - y) % (1 << 64)
        assert min(d, (1 << 64) - d) < bound


# --- ufhe keysets ------------------------------------------------------------

def test_ufhe_keyset_roundtrip(tmp_path):
    """The port's own ufhe keysets at TOY: the private keyset, the context
    (holding the public keyset) and an encrypted integer come back equal,
    and the loaded keyset decrypts the loaded integer."""
    gen = torch.Generator().manual_seed(20)
    p = tparams.TOY
    priv = tufhe.new_priv_keyset(gen, p, device=CPU)
    ctx = tufhe.setup_context(tufhe.new_public_keyset(gen, priv, 4,
                                                      device=CPU))
    c = tufhe.encrypt_integer(gen, 11, 4, False, priv, ctx)
    back = {}
    for name, obj in (("priv", priv), ("ctx", ctx), ("int", c)):
        tio.save(tmp_path / f"{name}.mtpu", obj)
        back[name] = tio.load(tmp_path / f"{name}.mtpu", device=CPU)
        _assert_port_equal(back[name], obj)
    assert tufhe.decrypt_integer(back["int"], back["priv"], back["ctx"]) == 11

"""The port's host codecs: `native` (the C++ PRNG streams, built by the
port into its own build directory), `seeded.MosfhetSeededTRLWE` and
`refrng.RefStream`.

- each library entry point against its plain numpy/hashlib version, AES
  against the FIPS-197 known answer; concurrent builds;
- `seeded.expand_mosfhet` against the TPU package's plain expansions, and a
  reference-format sample made here decrypting after expansion;
- `RefStream` against the `v3_replay_*` files the reference wrote with its
  counter seed: the raw stream, Box-Muller noise, keys and encryptions bit
  for bit, and the unfolding-1 bootstrap key rebuilt from the stream
  bootstrapping the reference's input within 2^34 of its output."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from mosfhet_tpu import native as jnative
from mosfhet_torch import bootstrap as tbs, bridge, io as tio, native, \
    ntt as tntt, seeded, tlwe as ttlwe, torus as ttorus, trgsw as ttrgsw, \
    trlwe as ttrlwe
from mosfhet_torch.polynomial import naive_negacyclic_mul
from mosfhet_torch.refrng import RefStream
from tests.test_torch_suite_env import port_test_env  # noqa: F401

CPU = "cpu"
SEED = bytes(range(16))
VEC = os.path.join(os.path.dirname(__file__), "vectors")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_polys,N", [(1, 4), (3, 256), (2, 2048)])
def test_xoroshiro_matches_plain(n_polys, N):
    got = native.xoroshiro_expand(SEED, n_polys, N)
    np.testing.assert_array_equal(got, native.xoroshiro_expand_plain(
        SEED, n_polys, N))
    np.testing.assert_array_equal(got, jnative.xoroshiro_expand_np(
        SEED, n_polys, N))


@pytest.mark.parametrize("seed,nbytes", [(SEED, 1000), (SEED, 777),
                                         (bytes(range(256)) * 2, 64),
                                         (b"", 200)])
def test_shake_matches_hashlib(seed, nbytes):
    assert native.shake128_expand(seed, nbytes) == \
        native.shake128_expand_plain(seed, nbytes)
    assert native.shake256_expand(seed, nbytes) == \
        native.shake256_expand_plain(seed, nbytes)


def test_aes128_fips197_and_counter_order():
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    pt = bytes.fromhex("3243f6a8885a308d313198a2e0370734")
    assert native.aes128_ctr(key, pt, 1).hex() == \
        "3925841d02dc09fbdc118597196a0b32"
    # both counters start at the iv; the LE form steps the high u64
    # little-endian, the other the last 8 bytes big-endian
    iv = bytes(range(32, 48))
    le, be = native.aes128_ctr_le(key, iv, 3), native.aes128_ctr(key, iv, 3)
    assert le[:16] == be[:16] == native.aes128_ctr(key, iv, 1)
    for out, order in ((le, "little"), (be, "big")):
        ctr = (int.from_bytes(iv[8:], order) + 2) % (1 << 64)
        assert out[32:] == native.aes128_ctr(
            key, iv[:8] + ctr.to_bytes(8, order), 1)
    with pytest.raises(ValueError):
        native.aes128_ctr(key[:15], iv, 1)


def test_concurrent_builds(tmp_path):
    """Four processes build the library into one empty directory at once:
    each loads a whole library (the move into place is atomic)."""
    code = ("import sys, pathlib\n"
            "from mosfhet_torch import native\n"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "native.LIB_PATH = native.BUILD_DIR / 'libmosfhet_native.so'\n"
            "print(native.xoroshiro_expand(bytes(16), 1, 4)[0, 0])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    want = str(native.xoroshiro_expand_plain(bytes(16), 1, 4)[0, 0])
    assert [o.strip() for o, _ in outs] == [want] * 4
    assert [f.name for f in tmp_path.iterdir()] == ["libmosfhet_native.so"]


def test_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "lib.so")
    (tmp_path / "src").mkdir()
    for name in ("xoroshiro", "keccak", "aes_ctr"):
        (tmp_path / "src" / f"{name}.cc").write_text("not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


# --- reference-format seeded samples ----------------------------------------

@pytest.mark.parametrize("prng", ["xoroshiro", "shake"])
def test_expand_mosfhet_matches_plain(prng):
    k, N = 2, 64
    rs = np.random.default_rng(5)
    seeds = rs.integers(0, 256, (2, 3, 16), dtype=np.uint8)
    b = rs.integers(0, 1 << 64, (2, 3, N), dtype=np.uint64)
    c = bridge.mosfhet_seeded_trlwe_from_numpy(seeds, b, k, prng, CPU)
    full = seeded.expand_mosfhet(c)
    assert full.a.shape == (2, 3, k, N) and full.b is c.b
    for idx in np.ndindex(2, 3):
        s = seeds[idx].tobytes()
        want = (jnative.xoroshiro_expand_np(s, k, N) if prng == "xoroshiro"
                else np.frombuffer(jnative.shake128_expand_np(s, 8 * k * N),
                                   dtype="<u8").reshape(k, N))
        np.testing.assert_array_equal(bridge.to_numpy(full.a[idx]), want)


def test_mosfhet_seeded_sample_decrypts():
    """A reference-format sample built here from the xoroshiro mask
    decrypts to its message after expansion."""
    N, k = 64, 1
    gen = torch.Generator().manual_seed(0)
    key = ttrlwe.new_binary_key(N, k, 2.0**-40, gen, CPU)
    m = ttorus.double2torus(torch.arange(N, dtype=torch.float64) / (2 * N),
                            CPU)
    a = bridge.to_tensor(native.xoroshiro_expand(SEED, k, N), CPU)
    b = ttrlwe._key_mul_accum(a, key) + m
    c = seeded.MosfhetSeededTRLWE(
        seed=torch.frombuffer(bytearray(SEED), dtype=torch.uint8), b=b, k=k)
    assert torch.equal(ttrlwe.phase(seeded.expand_mosfhet(c), key), m)
    with pytest.raises(ValueError):
        seeded.expand_mosfhet(seeded.MosfhetSeededTRLWE(c.seed, b, k, "aes"))


def test_vaes_sample_decrypts():
    """The reference's vaes sample (process key 1..16) expanded through
    AES-CTR decrypts its message within the reference's FFT noise."""
    with open(os.path.join(VEC, "v2_vaes_trlwe_key.bin"), "rb") as f:
        key = tio.import_mosfhet_trlwe_key(f, device=CPU)
    with open(os.path.join(VEC, "v2_vaes_compressed.bin"), "rb") as f:
        c = tio.import_mosfhet_compressed_trlwe_vaes(f, 1, 256,
                                                     bytes(range(1, 17)),
                                                     device=CPU)
    msg = (3 * torch.arange(256, dtype=torch.int64) + 1) << 47
    err = (ttrlwe.phase(c, key) - msg).abs().max()
    assert err <= 2**30


# --- the replayed reference stream ------------------------------------------

N_LWE, N_RING, K, L, BG_BIT = 32, 256, 1, 2, 9
S_LWE, S_RLWE = 1.0 / (1 << 15), 1.0 / (1 << 40)


def _vec(name):
    with open(os.path.join(VEC, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def replay():
    """The generator's draws in its order (`genvec_replay.c`)."""
    st = RefStream()
    out = {"stream": b"".join(st.bytes(n)
                              for n in [16, 100, 600, 16, 1000, 512, 3]),
           "normal": st.normal_torus_array(S_LWE, 256),
           "s_lwe": st.binary_key(N_LWE),
           "s_ring": st.trlwe_binary_key(N_RING, K)}
    out["tlwe"] = [st.tlwe_encrypt((i << 61) & ((1 << 64) - 1), out["s_lwe"],
                                   S_LWE) for i in range(4)]
    out["trlwe_a"], out["trlwe_e"] = st.trlwe_draws(N_RING, K, S_RLWE)
    out["bk_draws"] = [[st.trlwe_draws(N_RING, K, S_RLWE)
                        for _ in range((K + 1) * L)] for _ in range(N_LWE)]
    out["bs_in"] = st.tlwe_encrypt(1 << 61, out["s_lwe"], S_LWE)
    return out


def test_replay_stream_noise_and_keys(replay):
    assert replay["stream"] == _vec("v3_replay_stream.bin")
    np.testing.assert_array_equal(
        replay["normal"], np.frombuffer(_vec("v3_replay_normal.bin"), "<u8"))
    raw = _vec("v3_replay_tlwe_key.bin")
    assert struct.unpack("<id", raw[:12]) == (N_LWE, S_LWE)
    np.testing.assert_array_equal(np.frombuffer(raw[12:], "<u8"),
                                  replay["s_lwe"].astype(np.uint64))
    raw = _vec("v3_replay_trlwe_key.bin")
    np.testing.assert_array_equal(np.frombuffer(raw[16:], "<u8"),
                                  replay["s_ring"].reshape(-1).astype(
                                      np.uint64))


def test_replay_encryptions(replay):
    """TLWE encryptions whole (integer arithmetic in the reference), the
    TRLWE mask whole and its b within the reference's FFT noise."""
    with open(os.path.join(VEC, "v3_replay_tlwe_samples.bin"), "rb") as f:
        for a, b in replay["tlwe"]:
            c = tio.import_mosfhet_tlwe(f, N_LWE, device=CPU)
            np.testing.assert_array_equal(bridge.to_numpy(c.a), a)
            assert bridge.to_numpy(c.b) == b
    with open(os.path.join(VEC, "v3_replay_trlwe_sample.bin"), "rb") as f:
        c = tio.import_mosfhet_trlwe(f, K, N_RING, device=CPU)
    np.testing.assert_array_equal(bridge.to_numpy(c.a), replay["trlwe_a"])
    b = _exact_b(replay["trlwe_a"], replay["trlwe_e"], replay["s_ring"]) \
        + (torch.arange(N_RING, dtype=torch.int64) << 50)
    assert (c.b - b).abs().max() < 2**28


def _exact_b(a, e, s):
    """b = e + sum_j a_j s_j, the exact negacyclic product."""
    b = bridge.to_tensor(e, CPU)
    for j in range(a.shape[0]):
        b = b + naive_negacyclic_mul(bridge.to_tensor(a[j], CPU),
                                     torch.from_numpy(s[j].copy()))
    return b


def test_replayed_key_bootstraps_like_the_reference(replay):
    """The unfolding-1 key rebuilt exactly from the stream, the replayed
    input, the port's plain bootstrap: within 2^34 of the reference's
    output phase (its accumulated f64 FFT error), both in slot 1."""
    rows = []
    for i in range(N_LWE):
        r = torch.stack([torch.cat([bridge.to_tensor(a, CPU),
                                    _exact_b(a, e, replay["s_ring"])[None]])
                         for a, e in replay["bk_draws"][i]])
        rows.append(ttrgsw._add_monomial_rows(
            r, torch.tensor(int(replay["s_lwe"][i])), torch.tensor(0), L,
            BG_BIT, K, N_RING))
    with open(os.path.join(VEC, "v3_replay_trlwe_key.bin"), "rb") as f:
        rkey = tio.import_mosfhet_trlwe_key(f, device=CPU)
    plan = ttrgsw.new_key(rkey, L, BG_BIT).plan()
    g = ttrgsw.to_dft(ttrgsw.TRGSW(rows=torch.stack(rows), l=L,
                                   Bg_bit=BG_BIT), plan, with_shoup=True)
    bk = tbs.BootstrapKey.from_dft(g.v, g.vs, N_LWE, K, N_RING, L, BG_BIT,
                                   plan.primes)
    with open(os.path.join(VEC, "v3_replay_bs_in.bin"), "rb") as f:
        c_in = tio.import_mosfhet_tlwe(f, N_LWE, device=CPU)
    tv = ((torch.arange(N_RING) // (N_RING // 4) + 1) << 59).to(torch.int64)
    out = tbs.functional_bootstrap(ttrlwe.noiseless_trivial(tv, K, N_RING),
                                   c_in, bk, 4)
    with open(os.path.join(VEC, "v3_replay_bs_out.bin"), "rb") as f:
        c_ref = tio.import_mosfhet_tlwe(f, K * N_RING, device=CPU)
    key_out = ttrlwe.extract_tlwe_key(rkey)
    ph, ph_ref = (int(ttlwe.phase(c, key_out)) % (1 << 64)
                  for c in (out, c_ref))
    for x, y, bound in ((ph, 2 << 59, 2**52), (ph_ref, 2 << 59, 2**52),
                        (ph, ph_ref, 2**34)):
        d = (x - y) % (1 << 64)
        assert min(d, (1 << 64) - d) < bound
    # the reference's own DFT-layout save of that key imports to the
    # same rows, to the f64 precision of its torus-sized b words
    with open(os.path.join(VEC, "v3_replay_bootstrap_key.bin"), "rb") as f:
        bk_ref = tio.import_mosfhet_bootstrap_key_dft(f, device=CPU)
    assert bk_ref.primes == bk.primes
    mine = tntt.garner_u64(tntt.inverse_ntt(bk.v, plan), plan)
    theirs = tntt.garner_u64(tntt.inverse_ntt(bk_ref.v, plan), plan)
    assert (mine - theirs).abs().max() < 2**30

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mosfhet_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; any failure ends the script with a non-zero exit and no result line:

  1. card     CUDA present; the card's name and power limit (nvidia-smi).
  2. build    every kernel under mosfhet_torch/ops/csrc/ with nvcc, sm_90a;
              the registers and spills (ptxas -v) of every instance of K1,
              K1-step, K3, K4, K7, K8a, K8b, K1-delta, K6, K6-old (K6's
              gathered instances; K3-step launches K3's), K2 and K5 (which
              K5-v1 launches).
  3. kernel   the blind-rotate kernel against its plain PyTorch version at
              full TFHEpp-L2 width on random inputs, a short rotation, with
              exponents 0 and 2N present: bit-exact.
  4. main     TFHEPP_L2 through the entry points a user calls: keygen,
              tlwe.encrypt of a batch of 512, bootstrap.functional_bootstrap
              with a random 4-slot LUT, tlwe.phase decrypt within 2^58.  The
              launch counts are zeroed just before and read just after: the
              rotation must have gone through the kernel, never the plain
              version, and no key switch ran.
  5. compare  the kernel and the plain version on the main path's own
              rotation inputs (all 512 ciphertexts): bit-exact, both timed;
              K1's and K1-step's resident blocks per SM (the CUDA
              occupancy query) and K1's wave curve, ms per ciphertext at
              B = 132, 264, 396, 512, 528 of the path's ciphertexts.
 4b. steps    (run after 5, whose K1 output it is held to)
              bootstrap.blind_rotate_stepwise on phase 4's key, LUT and 512
              ciphertexts: counts zeroed just before the call and read just
              after (exactly n = 632 K1-step launches, no K1), words equal to
              phase 5's K1 output; warm ms beside blind_rotate's; K1-step
              timed per launch on the path's first step beside its bound and
              its plain version on that step (bit-exact); n K1-step launches
              and K1 on one wave of the ciphertexts (as many as the card
              keeps resident: 264 at L2, two blocks per SM), word-equal and
              timed.
  6. ks       the key-switch kernel against its plain version at full
              TFHEpp-L2 key-switch widths (n_in=2048, t=8, base 16,
              n_out=632) on random digits (0 and 15 present) and a random
              table: bit-exact.
  7. gate     the L2 key-switch key made by the port's tlwe.new_ks_key on
              the card (timed); tlwe.keyswitch of phase 4's 512 outputs
              back to the LWE key: one kernel launch, no plain call, words
              equal to the plain version's, decrypt within 2^60; the kernel
              launched once, then timed per launch beside its bound, the
              ceiling of a gather from shared memory and the plain version,
              with its schedule (tile, slice, chunk, cluster size, blocks,
              clusters and blocks resident) and the table bytes it moves
              through L2 per call.
  8. fdfb     bootstrap.fdfb_this_work at TFHEPP_L2, batch 512, precision
              3, every message m = i mod 8: counts zeroed just before, read
              just after (2 rotation launches and 1 key-switch launch per
              call, no plain call); decrypt within 2^58 of the LUT; the
              whole call with the plain versions on the first 2
              ciphertexts gives the same words; K2 on the path's own
              key-switch digits (its sign bootstrap's output), held to the
              plain version and reported as in phase 7.
  9. k345     the external-product apply-scan kernel (K3, broadcast and
              per-row keys, G=2, B=5), the unfolded-rotation kernel (K4) and
              the UBR phase-1 kernels K5 and K5-v1 (u = 2, 4, 8 with G = 2,
              2, 1 and B=3, exponents 0, N and 2N present; and u=4, G=2 at
              one ciphertext, a tile less one, a tile, a tile plus one and
              64: B = 1, 7, 8, 9, 64 with u64 words and, at L2_32 widths,
              B = 1, 2, 3, 64 with u32 words), the one-step
              kernels K1-step (B=5, exponents 0, N and 2N present) and
              K3-step (both key modes) against their plain versions at full
              TFHEpp-L2 widths on random inputs: bit-exact.
 10. unfolded TFHEPP_L2 with unfolding u=4: the port's keygen (timed, key
              bytes printed), then bootstrap.functional_bootstrap on phase
              4's LUT and 512 ciphertexts: exactly 1 K4 launch per call and
              nothing else, decrypt within 2^58; K4 timed per launch beside
              its bound and its plain version on the same inputs
              (bit-exact).
 11. ubr      TFHEPP_L2 with u=8: keygen (chunked), one ciphertext of
              m = 2/8, 256 random 4-slot LUTs; multivalue phase 1 is 1 K5
              launch, phase 2 is 1 K3 launch; every LUT within 2^58 of its
              slot 2; both kernels timed beside their bounds and their plain
              versions on the same inputs (bit-exact); peak device memory.
              Then UBR phase 1 of phase 4's first 64 ciphertexts
              (`k5_batch_phase`): 1 K5 launch counted, warm ms, K5 alone
              beside its bound and its shared-memory ceiling, ciphertexts 0,
              1 and 63 held to the plain version, K5's schedule and
              resident blocks per SM at B = 1 and 64.
11b. ubrsteps phase 11's ciphertext, LUTs and cache through
              bootstrap.multivalue_bootstrap_UBR_phase1_v1 (1 K5-v1 launch
              of K5's kernel, words equal to K5's) and
              bootstrap.multivalue_bootstrap_UBR_phase2_stepwise (G = 79
              K3-step launches, words equal to phase 2's), counts zeroed
              just before each call and read just after; K5-v1 timed beside
              K5 on the same inputs and held to its plain version, the
              step form warm beside the fused phase 2 (ms per LUT for each),
              K3-step per launch on the first group beside its bound and its
              plain version (bit-exact); K3-step's placement and resident
              blocks per SM (K3's kernel at G = 1).
 12. extprod  trgsw.external_product at L2 on 512 TRLWEs, with one TRGSW
              broadcast and with one TRGSW per row: 1 K3 launch each,
              bit-exact against the plain version, decrypt within 2^58.
 13. ga67     the automorphism key-switch kernel (K6) on 64 ciphertexts
              with a random full 2048-entry keyset (ginv 1, 2N-1 and random
              ones; kidx 0 and N-1 present) and the GA rotation kernel (K7)
              with n cut to 4, B=8 (generators 1 and 2N-1 present) against
              their plain versions at full TFHEpp-L2 widths: bit-exact.
 14. ga       TFHEPP_L2 through the GA bootstrap: the port's GA keygen
              (timed, key bytes printed), then
              bootstrap_ga.functional_bootstrap_ga on phase 4's LUT and 512
              ciphertexts, torus base 4: exactly 1 K6 and 1 K7 launch per
              call and nothing else, decrypt within 2^58; K6 and K7 timed per
              launch beside their bounds and their plain versions on the
              path's own inputs (bit-exact), and K7 once more with every
              generator 1 (its keyset reads all from one L2-resident entry);
              K7's resident blocks per SM and its wave curve, as K1's in
              phase 5, and K6's resident blocks per SM.
14b. steps    the per-step GA forms on phase 14's key and 512 ciphertexts:
              bootstrap_ga.blind_rotate_ga_stepwise (n K1-delta and n+1 K6
              launches per call) and blind_rotate_ga_gathered (n K1-delta
              and n+1 K6-old launches, no K6), counts zeroed just before
              each call and read just after, words equal to phase 14's K7
              output; warm ms beside blind_rotate_ga's and K7's; K1-delta,
              K6 and K6-old timed per launch on the path's first step beside
              their bounds and their plain versions (bit-exact); K1-delta's
              resident blocks per SM, K6-old's (K6's kernel) and its
              placement; the three timed again with their
              launches queued and on the host (us per wrapper call), and
              each form's device share (its kernels' queued ms times
              launches over the warm call's ms).
 15. trlweks  keyswitch.trlwe_keyswitch (from a second ring key) and
              keyswitch.eval_automorphism (a random odd generator, its key
              from new_automorphism_ks_keyset) on 512 TRLWEs: one K6 launch
              each, bit-exact against the plain version, decrypt within
              trlwe_ks_bound (2^40 at L2).
 16. tp       the gadget-row split CMUX step against its plain versions at
              full TFHEpp-L2 widths on random inputs (B=5, exponents 0, N
              and 2N present): K8a over key rows [0, J/2), [J/2, J) and
              [3J/4, J), K8b on 2 and 8 partials whose top residues sum
              past 2^32: bit-exact.
 17. mesh     parallel.mesh.pbs_on_mesh on phase 4's LUT, key and 512
              ciphertexts, on (data, model) meshes of the one card: (1, 2),
              (1, 4), (2, 2) through K8a and K8b, (2, 1) through K1.  Counts
              zeroed just before each mesh's calls and read just after:
              exactly n data model K8a and n data K8b launches per call
              (data K1 launches with model 1) and nothing else; words equal
              to phase 4's, decrypt within 2^58; first-call and warm ms,
              boot/s, peak memory.  K8a and K8b timed per launch on the
              path's own inputs (the (1, 2) mesh's first step; launches
              queued behind a wait kernel, so the host's time per launch
              leaves no gap) beside their bounds and their plain versions
              (bit-exact); K8a's and K8b's
              resident blocks per SM; for each mesh with model > 1, K8a and
              K8b timed at its first step's shapes, on the card and on the
              host (microseconds per wrapper call), and its device share
              (the kernels' ms times launches over the warm call's ms).
 18. meshplain unfolded_pbs_on_mesh with the u=4 key and ga_pbs_on_mesh with
              the GA key, model 2, on the first 32 ciphertexts: words equal
              to phase 10's (K4) and phase 14's (K7) outputs for them; these
              routes are plain PyTorch (no kernel launch), as in the TPU
              package.
 19. set3     params.SET_3 (n=807, N=4096, l=1, Bg_bit=22, 4 primes),
              where K1, K3, K4, K6, K7 and K8a keep some buffers in a global
              workspace: keygen (timed, key bytes), then
              bootstrap.functional_bootstrap on 512 ciphertexts at full
              depth: exactly 1 K1 launch per call, decrypt within 2^58; K1
              timed beside its bound and its plain version on the path's
              own inputs (bit-exact); then K3 (both key modes), K4 (u=2), K7
              (a 64-entry keyset), K8a (rows [0, 2) and [1, 2)), K1-step
              and K3-step (both key modes; their placements printed) at
              SET_3 widths with cut depth on 64 random ciphertexts, each
              timed beside its bound and held to its plain version
              (bit-exact); K8a's and K8b's resident blocks per SM;
              then the GA keygen and bootstrap_ga.functional_bootstrap_ga
              on the same 512 ciphertexts (1 K6 and 1 K7 launch per call,
              decrypt within 2^58), K6 held to its plain version on the
              path's inputs, and K6-old on those inputs permuted and their
              keyset entries gathered (its plain version's and K6's words;
              placement printed), K6's and K7's resident blocks per SM.
19b. n8192    K8b at N=8192 with 4 primes (SET_3's digits), where its
              C*P spectra exceed a block and it runs one pass per
              component: pbs_on_mesh on a (1, 2) mesh of the card with a
              random key cut to 8 steps on 64 random ciphertexts (16 K8a
              and 8 K8b launches, words equal to K1's bootstrap); K8b timed
              on the path's first step beside its bound and its plain
              version, and held to it on 4 random partials (bit-exact);
              K8a's and K8b's resident blocks per SM.
 20. torus32  the 32-bit torus, in a child interpreter (this script with
              --torus32 and MOSFHET_TORUS_BITS=32): K1's and K2's one-limb
              forms against their plain versions on random inputs; then
              `bench_torus32.py`'s L2_32 (n=632, N=2048, l=3, Bg_bit=7; key
              switch t=6, base_bit=4; 2 primes) through the entry points:
              keygen, functional_bootstrap of 512 ciphertexts (1 K1 launch
              per call, decrypt within 2^26), tlwe.keyswitch of its outputs
              (1 K2 launch, within 2^27), fdfb_this_work at precision 3 (2
              K1 and 1 K2 launches per call, within 2^26); K1 and K2 timed on
              the path's own inputs beside their bounds and plain versions
              (bit-exact; K2 on the gate's and the fdfb's digits, reported
              as in phases 7-8), with K1's residency and wave curve as in
              phase 5;
              blind_rotate_stepwise on the PBS's inputs (632 one-limb
              K1-step launches, words equal to its K1), timed as in phase
              4b (one wave: 396, three blocks per SM).  Then the one-limb
              K3, K4, K5, K8a and K8b on their paths: the u=4 keygen
              (seconds, bytes) and PBS of the same 512 ciphertexts (1 K4
              launch per call, decrypt within 2^28); UBR at u=4 (one ciphertext, 256 LUTs: 1 K5 and 1 K3
              launch, every LUT within 2^28), then its phase 1 v1 and phase
              2 step form as in phase 11b (1 one-limb K5-v1 and G = 158
              K3-step launches), and phase 1 of 64 ciphertexts as in phase
              11; trgsw.external_product on 512
              TRLWEs, broadcast and per row (1 K3 launch each, within
              2^26); pbs_on_mesh on (1, 2), (1, 3) and (2, 2) meshes of the
              card (J = 6 rows split over 2 or 3 shards; exact K8a and K8b
              counts, words equal to the one-limb K1 path's; K8a's and
              K8b's residency, device shares and host time as in phase 17);
              each kernel timed on its path's own inputs beside its bound
              and its plain version (bit-exact); unfolded_pbs_on_mesh at
              model 2 on 32 ciphertexts, equal to the K4 path's words.
              Then the GA family through the one-limb K6 and K7: the GA keygen
              (seconds, bytes, peak), functional_bootstrap_ga of the same
              512 ciphertexts (1 K6 and 1 K7 launch per call, decrypt
              within 2^27), K6 and K7 timed on the path's own inputs beside
              their bounds and plain versions (bit-exact; K7's plain on all
              512), K7's residency and wave curve as in phase 14, K6's
              residency,
              trlwe_keyswitch and eval_automorphism on 512 TRLWEs (1
              K6 launch each, within trlwe_ks_bound at 32 bits, 2^25), and
              ga_pbs_on_mesh at (2, 1) (2 K6 + 2 K7 launches) and at (1, 2)
              on 32 ciphertexts (the plain route), equal to the
              bootstrap's words.  Last, phase 21's matrix ops at L2_32 (l=3,
              Bg_bit=7, the primes of the TRGSW key's plan), then phase 22's
              L2_32 part, then phase 23's.  The child's failure fails the
              script.
 21. matrix   the TRGSW matrix ops on phase 4's TRGSW key: trgsw_mul
              (mul_trgsw_dft of TRGSW(X^5) and TRGSW(X^3), the exponent 8)
              and trgsw_reg_sub (registers of 9 and 4: 5 and N - 5; reg_add
              13 and N - 13), then 512 pairs of random exponents (seed 2024)
              built with the batched monomial_encrypt and to_dft: every
              mul_trgsw_dft output decrypts to (e1 + e2) mod N, every
              reg_sub half to its difference's index; counts zeroed just
              before and read just after: one K3 launch per
              debug_decrypt_exp_dft and nothing else; warm ms of
              mul_trgsw_dft, reg_sub and debug_decrypt_exp_dft and the peak
              memory; the plain ops' words (mul_trgsw_dft, from_dft, ntt_mul,
              full_mul_with_scale) on the first 4 rows equal to the same
              calls on CPU tensors; K3 on debug_decrypt_exp_dft's inputs
              timed beside its bound and its plain version (bit-exact).
 22. ksfamily the key-switch family on phase 4's ring key (`ks_family_phase`):
              `priv_ks` as the TPU matrix runs it (a private KS pair, t=8,
              base_bit=4, three primes; one priv_keyswitch_2 of a uniform
              message: exactly 2 K6 launches, the phase within 2^50 of
              -s m); `tlwe_mul` of 5 and 11 at precision 4 through a seeded
              packing1 key (the streamed gather; 1 K6 relinearization at
              four primes, t=2, base_bit=20) and through its expansion (1 K2
              launch for both packing switches, 1 K6): equal words, 7 by
              both, K2 timed on those two ciphertexts (below a tile of
              128 it stages the whole table); the packing1 switch streamed
              and by K2 on 16 TLWEs (equal words, the streamed one timed);
              at B=512 K2 on the dense table's rows of 4,096 words, K6 on
              the relinearization key (P=4) and on the pair's first key
              (P=3),
              each held bit-exact to its plain version and timed beside its
              bound; priv_keyswitch_2 of 512 TRLWEs and ks_b_to_a of one
              TRGSW (2 K6 launches each, the plain route's words); keygen
              seconds and bytes of the seeded and expanded tables, warm ms,
              peak.  Its L2_32 part runs at the end of the phase-20 child
              (`ks_family32_phase`): dense packing1 and private-SK tables
              (t=6, 3.02 GB each), packing1_keyswitch and priv_keyswitch of
              512 TLWEs (1 one-plane K2 launch each, within 2^27),
              priv_keyswitch_2 of 512 TRLWEs (2 one-limb K6 launches, within
              2^25), each kernel held bit-exact and timed.
 23. family   the rest of `bootstrap` on phase 4's keys and phase 22's
              dense packing1 table, relinearization key and private KS pair,
              with a dense private-SK table made here (`boot_family_phase`):
              the TPU matrix's trgsw_bootstrap, fdfb_ks21, fdfb_clot21 and
              circuit_bootstrap as it runs them (one ciphertext each, its
              bounds); then 512 ciphertexts of every message through the
              TRGSW bootstrap, CB v1-v3, fdfb_ks21 (both forms), fdfb_clot21
              and _2, multi-value CLOT21 and phases 1/2, and public_mux:
              exact launch counts (PERF.md section 3), decrypt bounds, warm
              ms, each call's plain route on the first 2 ciphertexts giving
              the same words; K1 on the TRGSW bootstrap's 4,096 rows (timed
              at full depth, held over its first 8 steps) and K2 on CB v1's
              private-SK rows, held and timed; peak memory.  Its L2_32 part
              runs at the end of the phase-20 child (`boot_family32_phase`).
 24. apps     ufhe at UFHE_SET0 (`apps_phase`): the port's keygens
              (seconds, bytes), 64 pairs of 6-bit integers through add, sub,
              mul, cmp, relu, lut_integer and mux_integer_array, every
              element decrypted to its cleartext, launches per op exactly
              `ufhe_launches`, warm ms; K1 at l=6 and K2 at base_bit=2 held
              and timed on the path's inputs; then the leveled LUT at L2
              (`eval_lut`: 1 K3; `eval_lut_vertical` over 4N entries: 2 K3,
              1 K1).
 25. io       keysets through `io` onto the card (`io_phase`): phase 4's
              u=1 key and phase 7's TLWE key-switch key saved in the
              versioned container and loaded, 512 gates (1 K1, 1 K2) with
              the in-memory keyset's words; a u=4 key in the reference's
              time-domain layout, back bit for bit, one PBS of 512 (1 K4)
              word-equal; phase 4's key in the FFNT and SPQLIOS f64 DFT
              layouts, 512 PBS (1 K1) within 2^58; phase 15's TRLWE
              key-switch key in both, 512 switched (1 K6) within 2^40; the
              reference's files under tests/vectors/ (u=2 key through K4,
              u=1 DFT keys through K1, TRLWE key-switch keys through K6,
              packing and packing1 keys through K2, the vaes sample, the
              replayed stream and its key through K1), each path also whole
              on the plain versions, word for word; ufhe's keyset, context
              and integers (phase 24's) saved and loaded, one add with the
              loaded context word-equal.  Bytes, seconds, peak, errors.
 26. report   the pbs, gate, fdfb, unfolded, ubr, steps (4b, 11b), extprod,
              trgsw_matrix, ga (with the per-step forms), trlweks, mesh, set3,
              ks_family, boot_family, apps, io and torus32 lines, the card
              line, the kernels line (the one-limb forms as
              `<kernel>/torus32`, K8b at N=8192 as `finish_step/n8192`,
              K1-delta as `cmux_delta`, K6-old as `auto_keyswitch`, K1-step
              as `pbs_step`, K3-step as `ext_product_apply_step`, K5-v1 as
              `ubr_phase1_combine_v1`), and the result line last.

`python3 chip_smoke.py --k5` times K5 alone at B = 1 and 64 at TFHEpp-L2
(u=8) and L2_32 (u=4), as the phases above time it, K5 at 64 under each
tile cap of K5_TILES, and K4 at the u=4 PBS's shape, on random inputs,
and prints one JSON line; a copy of the script in another checkout times
that checkout's kernels.

Imports nothing but PyTorch, numpy and the port.
"""

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 512          # the TPU bench's accelerator default
REPS = 3             # timed repetitions of the warm bootstrap
KS_REPS = 10         # timed launches of the key-switch kernel
K5_REPS = 10         # timed (queued) launches of K5 and K5-v1
FDFB_PREC = 3        # the TPU bench suite's fdfb_this_work precision
SEED = 2024
U_PBS = 4            # the README's best full-bootstrap unfolding
U_UBR = 8            # bench_unfolded.py's UBR unfolding for K >= 159 LUTs
UBR_LUTS = 256       # bench_unfolded.py's LUT count
DECRYPT_BOUND = 2.0**58
# Key-switch noise at L2: ~15,360 nonzero digits x (2^-15)^2 gives sigma
# ~2^-8.05 of the torus, ~2^56 in words; 2^60 is ~8 sigma.
KS_DECRYPT_BOUND = 2.0**60
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
INT32_LANES_PER_SM = 64     # Hopper SM: 64 INT32 units (Hopper white paper)
SHOUP_MULTIPLIES = 3        # one Shoup product: mulhi + two 32-bit multiplies
BARRETT_MULTIPLIES = 4      # a runtime-key product: mul, two mulhi, mul
CENTRED_SHOUP = 2           # a u64 word to one centred residue: two Shoup
U64_ADD_OPS = 2             # a u64 add as INT32 operations (a u32 add: 1)
SMEM_BYTES_PER_CLOCK = 128  # shared memory per SM and clock (Hopper)
RUNTIME_KEY_LIBRARY_NOTE = ("none: no PyTorch call computes an exact NTT "
                            "external product or an unfolded combine")
KERNELS = ("blind_rotate_scan", "tlwe_keyswitch_sum", "ext_product_apply_scan",
           "unfolded_rotate", "ubr_phase1_combine", "auto_keyswitch_stream",
           "ga_scan_fused", "partial_step", "finish_step", "cmux_delta",
           "auto_keyswitch", "pbs_step", "ext_product_apply_step",
           "ubr_phase1_combine_v1")
TP_LIBRARY_NOTE = ("none: no PyTorch call computes a partial external "
                   "product or an NTT-domain finish")
# (data, model) meshes of the one card for pbs_on_mesh (phase 17)
MESH_SHAPES = ((1, 2), (1, 4), (2, 2), (2, 1))
TP_REPS = 20         # timed launches of K8a, K8b and (queued) phase 14b's
QUEUE_WAIT_CYCLES = 20_000_000   # ~10 ms at 1980 MHz: longer than the host
                                 # takes to enqueue TP_REPS launches
MESH_CUT = 32        # ciphertexts of the plain-PyTorch mesh routes (phase 18)
GA_LIBRARY_NOTE = ("none: no PyTorch call computes an exact NTT key switch "
                   "with per-row keys or a Galois permutation")
STEP_LIBRARY_NOTE = ("none: no PyTorch call computes an exact NTT external "
                     "product")
STEP_REPS = 2        # timed calls of the per-step forms (phases 4b, 11b, 14b)
# K1's wave curve (phases 5, 20): one, two, three and four ciphertexts per
# SM of an H100's 132, and the main path's batch
WAVE_BATCHES = (132, 264, 396, 512, 528)
# the one-step kernels and K5-v1 (phases 4b, 9, 11b, 19, 20): each entry's
# TPU kernel line and library note
STEP_KERNELS = {
    "pbs_step": ("blind_rotate.cu", 1253, "none: no PyTorch call computes "
                 "an exact NTT CMUX step"),
    "ext_product_apply_step": ("ext_product_apply.cu", 1802,
                               STEP_LIBRARY_NOTE),
    "ubr_phase1_combine_v1": ("ubr_phase1.cu", 2744, "none: no PyTorch call "
                              "computes an exact unfolded combine")}
# UBR phase 1 at a batch (phases 11, 20): the main path's first ciphertexts
K5_BATCH = 64
K5_TILES = (1, 2, 4, 7, 8)   # `--k5`: caps of K5's tile timed at K5_BATCH
SET3_CUT = 64        # ciphertexts of the SET_3 K3, K4, K7, K8a checks
SET3_GA_ENTRIES = 64  # keyset entries of the SET_3 K7 check
# The 32-bit torus: benchmarks/bench_torus32.py's parameter set (L2_32)
L2_32 = dict(n=632, N=2048, k=1, l=3, Bg_bit=7, t=6, base_bit=4,
             lwe_sigma=2.0**-15, rlwe_sigma=2.0**-25, name="L2_32")
DECRYPT_BOUND_32 = 2.0**26   # bench_torus32.py:45,54
# Key-switch noise at L2_32: ~11,520 nonzero digits x (2^-15)^2 gives sigma
# ~2^-8.26 of the torus, ~2^23.7 in u32 words; 2^27 is ~10 sigma.
KS_DECRYPT_BOUND_32 = 2.0**27
TORUS32_TIMEOUT_S = 600
# The unfolded bootstrap and UBR at L2_32 (u=4): summing 2^u key products
# multiplies the per-group noise by ~2^(u/2) over n/u groups, ~2^26-2^27
# expected; 2^28 is half the 2^29 slot spacing of a 4-slot LUT.
UNFOLDED_BOUND_32 = 2.0**28
# The GA bootstrap at L2_32: per-step key-switch and external-product noise
# over 632 steps, sigma ~2^24 in u32 words expected; the TPU package's own
# TORUS32 GA test bound (tests/_torus32_suite.py:408).
GA_DECRYPT_BOUND_32 = 2.0**27
# (data, model) meshes of the card at L2_32, whose J = 6 gadget rows split
# over 2 or 3 model shards (not 4)
MESH_SHAPES_32 = ((1, 2), (1, 3), (2, 2))
# K8b at N=8192 with 4 primes (SET_3's digits): a random key cut to this
# depth, this many random ciphertexts, on a (1, 2) mesh of the card
N8192_DEPTH, N8192_BATCH = 8, 64
# Phase 22: the TPU matrix's priv_ks and tlwe_mul (full_matrix_tpu.py:167-169,
# 308-339): the pair's decrypt bound, tlwe_mul's inputs and precision, the
# relinearization gadget; ks_b_to_a's exponent
PRIV_KS_BOUND = 2.0**50
TLWE_MUL_INPUTS, TLWE_MUL_PREC = (5, 11), 4
RL_T, RL_BASE_BIT = 2, 20
KS_B_TO_A_EXP = 13
STREAM_CHECK = 16    # TLWEs of the streamed packing1 switch held to K2's
# The pair at L2_32 (t=6, base_bit=4): each digit's rounding (uniform
# within 2^7) times the key product s s' (binary keys: coefficients up to
# N/4, mean square ~(N/4)^2/3 = 2^16.4) over N = 2048 coefficients gives
# sigma ~(2^11 2^14/3 2^16.4)^(1/2) = 2^19.9 in u32 words; 2^25 is ~34 sigma
PRIV_KS_BOUND_32 = 2.0**25
# Phases 24-25: the rest of bootstrap and the applications.  FAMILY_REPS
# warm calls timed per function; each call's plain route on the first
# FAMILY_PLAIN ciphertexts (a plain K1 rotation takes ~5.5 s at L2 on one
# H100); K1 on the TRGSW rows held over its first ROWS_CHECK_STEPS steps
# (the plain version takes ~2 s per step on 4,096 rows); fdfb_ks21's torus
# base and fdfb_clot21's precision (full_matrix_tpu.py:341-366);
# bench_ufhe_batch.py's batch and precision
FAMILY_REPS = 1
FAMILY_PLAIN = 2
ROWS_CHECK_STEPS = 8
KS21_TB, CLOT21_PREC = 8, 4
UFHE_BATCH, UFHE_PREC = 64, 6
# Phase 25: the reference's files (tests/vectors/, generator n=32 or 16,
# N=256, k=1) and their bounds (tests/test_mosfhet_vectors*.py,
# tests/test_replay_vectors.py); the vaes vectors' process AES key.
VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "vectors")
VEC_N, VEC_K = 256, 1
VEC_KS_BOUND = 2.0**52      # t*base_bit = 16 bits of decomposition
VEC_AES_KEY = bytes(range(1, 17))
# CB v3's a rows are the private pair's switch of its b rows: the pair's
# noise (its phase 22 output reached 2^45.2 on one TRLWE, one H100) and the b
# rows' noise times the key, which the external product multiplies by
# digits up to 2^8 over l N = 8,192 terms.  Its 512 x 2,048 outputs
# reached 2^59.2 (measured on one H100) where v1's reach ~2^53: 2^60 for
# v3.  The TPU package checks v3 only at TOY, N = 64, against 2^59
# (tests/test_advanced.py:75-97).
CB3_BOUND = 2.0**60
# No PyTorch call computes the key-switch select-sum on int64 CUDA tensors.
KS_LIBRARY_NOTE = ("none: torch.sparse.mm of the one-hot digits and the "
                   "table raises \"addmm_sparse_cuda\" not implemented for "
                   "'Long' (torch 2.11.0+cu128); embedding_bag takes "
                   "floating weights only")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card, by CUDA events; returns the
    last result too."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def queued_ms(fn, reps):
    """Mean milliseconds per call on the card with every launch queued
    before the first runs: a wait kernel of QUEUE_WAIT_CYCLES holds the
    stream while the host enqueues the reps calls, so the host's time per
    launch (tens of microseconds, near a K8a or K8b launch's device time)
    leaves no gap between them.  Returns the last result too."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_WAIT_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def signed_max_abs(x):
    """max |x| over int64 words read as signed torus differences."""
    return float(x.to(torch.float64).abs().max().item()) if x.numel() else 0.0


def rotation_bound_ms(kp, n, B, key_bytes, max_clock_mhz):
    """Least time the card needs for an n-step rotation of B ciphertexts:
    the larger of its integer multiplies over the INT32 rate and its bytes
    (key read once, accumulators in and out, exponents) over HBM."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    butterflies = (J * P + C * P) * (N // 2) * int(math.log2(N))
    mod_products = butterflies + J * C * P * N + C * N
    multiplies = SHOUP_MULTIPLIES * mod_products * n * B
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6
    nbytes = key_bytes + 2 * B * C * N * kp.torus_bits // 8 + n * B * 4
    t_ops, t_bytes = multiplies / int_rate, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "multiplies": multiplies, "bytes": nbytes,
            "int32_per_s": int_rate, "mod_products_per_step": mod_products}


def keyswitch_bound_ms(dig, ab, max_clock_mhz):
    """Least time the card needs for the select-sum on these digits: the
    larger of its word adds (one per nonzero digit and column; 2 INT32
    operations for a u64 word, 1 for a u32 word) over the INT32 rate and its
    bytes (the distinct table rows the digits select, read once, the
    digits, the output) over HBM."""
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6
    w = ab.element_size()
    nbytes = rows * width * w + dig.numel() * dig.element_size() + B * width * w
    ops = adds * w // 4
    t_ops, t_bytes = ops / int_rate, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "word_adds": adds, "int32_ops": ops, "bytes": nbytes,
            "rows_selected": rows, "int32_per_s": int_rate}


def k2_report(pk, tag, dig, ab, max_clock_mhz):
    """K2 on these inputs, launched once before KS_REPS timed launches:
    ms per launch beside its bound, and its schedule
    (`tlwe_keyswitch_schedule`).  The log line adds two figures worked out
    from the design, not read from the card: the ceiling of a gather from
    shared memory (every selected word loaded once at SMEM_BYTES_PER_CLOCK
    per SM and clock), and the table bytes the schedule copies from L2 per
    call (each tile of ciphertexts copies the whole table's slices once)
    against the selected rows per ciphertext that the first design read.
    Returns the report and the last output."""
    pk.tlwe_keyswitch_sum(dig, ab)
    torch.cuda.synchronize()
    ms, out = cuda_ms(lambda: pk.tlwe_keyswitch_sum(dig, ab), KS_REPS)
    B, n_in, t = dig.shape
    w = ab.element_size()
    bound = keyswitch_bound_ms(dig, ab, max_clock_mhz)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ceiling = 1e3 * bound["word_adds"] * w / (
        SMEM_BYTES_PER_CLOCK * sms * max_clock_mhz * 1e6)
    sched = pk.tlwe_keyswitch_schedule(B, n_in * t, ab.shape[2], ab.shape[3],
                                       8 * w)
    r = {"ms": ms, "bound": bound, "share_of_bound": bound["bound_ms"] / ms,
         "schedule": sched}
    log(f"# K2 {tag}, B={B}: {ms:.4f} ms/launch (one launch, then the mean "
        f"of {KS_REPS}); bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}), {100 * r['share_of_bound']:.1f}% of it; "
        f"derived from the design, not measured: shared-memory ceiling "
        f"{ceiling:.4f} ms ({bound['word_adds']:.4g} words of {w} B at "
        f"{SMEM_BYTES_PER_CLOCK} B per SM and clock), table slices the "
        f"schedule copies from L2 {sched['tiles'] * ab.numel() * w / 1e9:.3f}"
        f" GB per call (the first design's selected rows per ciphertext "
        f"{bound['word_adds'] * w / 1e9:.3f} GB); "
        f"schedule: {sched['tile']} ciphertexts x {sched['slice']} columns "
        f"per block, {sched['chunk_rows']}-row chunks in {sched['stages']} "
        f"stages of {sched['stage_bytes']} B ({sched['smem']} B per block), "
        f"{sched['tiles']} tiles x {sched['slices']} slices x cluster "
        f"{sched['cluster']} = {sched['blocks']} blocks of "
        f"{sched['threads']} threads, {sched['clusters_resident']} clusters "
        f"and {sched['blocks_per_sm']} blocks per SM resident (clusters of "
        f"1..16 blocks resident: {sched['clusters_by_size']})")
    if sched["blocks_per_sm"] < 1:
        fail(f"K2 {tag}: no block fits an SM")
    return r, out


def fdfb_ks_digits(bootstrap, tlwe, trlwe, torus, c, bk, ksk, precision):
    """The digits of fdfb_this_work's key switch (`bootstrap.fdfb_this_work`:
    the key switch of its sign bootstrap's output), to time K2 on that
    path's own inputs."""
    sign = torus.to_signed((1 << (torus.TORUS_BITS - 2))
                           - (1 << (torus.TORUS_BITS - precision - 2)))
    tv_sign = trlwe.torus_packing(torch.tensor(
        [sign], dtype=torus.TORUS_DTYPE, device=c.b.device), bk.k, bk.N)
    ct = bootstrap.functional_bootstrap(tv_sign, c, bk, 1 << (precision - 1))
    return tlwe.keyswitch_inputs(ct, ksk)


def k2_entry(name, launches, launches_by_path, gate, fdfb, plain_ms,
             library_ms, library_note):
    """K2's kernels-line entry: the gate's inputs' time, the fdfb's beside
    it, and the launch's placement and residency."""
    return {
        "name": name, "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/tlwe_keyswitch.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:2070",
        "launches": launches, "launches_by_path": launches_by_path,
        "max_abs_err": 0.0, "bit_exact": True, "ms": gate["ms"],
        "plain_ms": plain_ms, "bound_ms": gate["bound"]["bound_ms"],
        "bound_by": gate["bound"]["bound_by"], "library_ms": library_ms,
        "library_note": library_note, "fdfb_ms": fdfb["ms"],
        "fdfb_bound_ms": fdfb["bound"]["bound_ms"],
        "placement": "{tile} ciphertexts x {slice} columns per block, "
                     "cluster {cluster}, {blocks} blocks".format(
                         **gate["schedule"]),
        "resident_blocks_per_sm": gate["schedule"]["blocks_per_sm"]}


def int_rate_per_s(max_clock_mhz):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6


def ops_bytes_bound(int32_ops, nbytes, max_clock_mhz):
    """The larger of INT32 operations over the INT32 rate and bytes over
    HBM, in ms, with its basis."""
    rate = int_rate_per_s(max_clock_mhz)
    t_ops, t_bytes = int32_ops / rate, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "int32_ops": int32_ops, "bytes": nbytes, "int32_per_s": rate}


def butterflies(kp, rows):
    return rows * (kp.N // 2) * int(math.log2(kp.N))


def word_bytes(kp):
    """Bytes of one torus word at the plan's width (8 or 4)."""
    return kp.torus_bits // 8


def word_ops(kp):
    """INT32 operations of a word add, and Shoup products of a word's
    centred residue, at the plan's width: (2, 2) for u64, (1, 1) for u32."""
    return (U64_ADD_OPS, CENTRED_SHOUP) if kp.torus_bits == 64 else (1, 1)


def apply_scan_bound(kp, B, G, per_row, max_clock_mhz):
    """K3, per ciphertext and step: J*P digit and C*P inverse NTTs (one
    Shoup product per butterfly), J*C*P*N Barrett products, one Garner
    product per output word; bytes: the keys read once, acc in and out."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    shoup = butterflies(kp, J * P + C * P) + C * N
    ops = (SHOUP_MULTIPLIES * shoup + BARRETT_MULTIPLIES * J * C * P * N) \
        * B * G
    nbytes = (G * (B if per_row else 1) * J * C * P * N * 4
              + 2 * B * C * N * word_bytes(kp))
    return ops_bytes_bound(ops, nbytes, max_clock_mhz)


def unfolded_bound(kp, B, G, M, max_clock_mhz):
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
    nbytes = ((G * M * J * C * N + 2 * B * C * N) * word_bytes(kp)
              + B * G * M * 4)
    return ops_bytes_bound(ops, nbytes, max_clock_mhz)


def ubr_phase1_bound(kp, B, G, M, max_clock_mhz):
    """K5, per ciphertext and group: J*C*P key NTTs, J*C*P*N centred
    reductions, J*C*N*M word rotate-adds; bytes: the key products read once,
    the exponents, the u32 output."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    add_ops, centred = word_ops(kp)
    shoup = butterflies(kp, J * C * P) + centred * J * C * P * N
    ops = (SHOUP_MULTIPLIES * shoup + add_ops * J * C * N * M) * B * G
    nbytes = (G * M * J * C * N * word_bytes(kp) + B * G * M * 4
              + B * G * J * C * P * N * 4)
    return ops_bytes_bound(ops, nbytes, max_clock_mhz)


def trlwe_ks_bound(p, t, base_bit, bits=64, key_err=0.0):
    """Decrypt bound of a TRLWE key switch with t digits of base_bit bits
    under a binary ring key, on the bits-bit torus: per coefficient k t N
    products of a digit (uniform, variance 2^(2 base_bit)/12) with a key
    row's noise (sigma rlwe_sigma 2^bits in words, plus key_err, the
    largest error of the key's words beyond their noise, taken as uniform
    in [-key_err, key_err]: the f64 rounding of a key read from a DFT
    layout), plus the k N/2 dropped remainders of the mask words (uniform
    below 2^(bits - t base_bit)) times the key bits, plus the input's own
    noise.  Returns 2^ceil(log2(64 sigma)): 2^40 at TFHEpp-L2 with t=4,
    base_bit=9 (sigma 2^33.7); 2^25 at L2_32 with t=3, base_bit=7 (sigma
    2^18.6)."""
    sig_w = p.rlwe_sigma * 2.0**bits
    var = (p.k * t * p.N * 2.0**(2 * base_bit) / 12
           * (sig_w**2 + key_err**2 / 3)
           + p.k * p.N / 2 * 2.0**(2 * (bits - t * base_bit)) / 12
           + sig_w**2)
    return 2.0**math.ceil(math.log2(64 * math.sqrt(var)))


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


def auto_ks_bound(kp_ks, B, kidx, max_clock_mhz):
    """K6: one key switch per ciphertext (a step's second half); bytes: the
    distinct keyset entries read once, the words in and out, kidx and
    ginv."""
    nbytes = (distinct_entry_bytes(kidx, kp_ks)
              + 2 * B * kp_ks.C * kp_ks.N * word_bytes(kp_ks) + B * 8)
    return ops_bytes_bound(auto_ks_ops(kp_ks, B), nbytes, max_clock_mhz)


def auto_ks_gathered_bound(kp_ks, B, max_clock_mhz):
    """K6-old: K6's operations; bytes: the B gathered keyset rows (one entry
    per ciphertext, each an input read once), the words in and out."""
    nbytes = (B * entry_bytes(kp_ks)
              + 2 * B * kp_ks.C * kp_ks.N * word_bytes(kp_ks))
    return ops_bytes_bound(auto_ks_ops(kp_ks, B), nbytes, max_clock_mhz)


def cmux_delta_bound(kp, B, max_clock_mhz):
    """K1-delta for B ciphertexts: per ciphertext J*P digit and C*P inverse
    NTTs, J*C*P*N key products (counted as Shoup products: the function is
    given the key's Shoup companions, as K1's bound counts them) and one
    Garner product per word; bytes: the TRGSW's residues read once (the
    companions are not needed to move), the words in and out."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    shoup = butterflies(kp, J * P + C * P) + J * C * P * N + C * N
    nbytes = J * C * P * N * 4 + 2 * B * C * N * word_bytes(kp)
    return ops_bytes_bound(SHOUP_MULTIPLIES * shoup * B, nbytes,
                           max_clock_mhz)


def ga_bound(kp, kp_ks, gens, max_clock_mhz):
    """K7 over n steps and B ciphertexts.  Per step and ciphertext: the
    external product (J*P digit and C*P inverse NTTs, J*C*P*N Shoup key
    products, one Garner product per word), then the key switch (Jk*Pk digit
    and C*Pk inverse NTTs, Jk*C*Pk*N Barrett key products, Garner).  Bytes:
    the TRGSW keys and the distinct keyset entries these generators select,
    each read once, acc in and out, the generators.  Also the keyset bytes
    the blocks gather (one entry per ciphertext and step)."""
    n, B = gens.shape
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    Jk, Pk = (C - 1) * kp_ks.l, kp_ks.P
    shoup = (butterflies(kp, J * P + C * P) + J * C * P * N + C * N
             + butterflies(kp_ks, Jk * Pk + C * Pk) + C * N)
    barrett = Jk * C * Pk * N
    ops = (SHOUP_MULTIPLIES * shoup + BARRETT_MULTIPLIES * barrett) * n * B
    kidx = (gens.to(torch.int64) - 1) >> 1
    nbytes = (2 * n * kp.J * kp.C * kp.P * kp.N * 4
              + distinct_entry_bytes(kidx, kp_ks)
              + 2 * B * kp.C * kp.N * word_bytes(kp) + n * B * 4)
    out = ops_bytes_bound(ops, nbytes, max_clock_mhz)
    out["gathered_bytes"] = n * B * entry_bytes(kp_ks)
    out["products_per_step"] = shoup + barrett
    return out


def partial_step_bound(kp, B, j_local, max_clock_mhz):
    """K8a for B ciphertexts over j_local key rows: per ciphertext j_local*P
    digit NTTs and j_local*C*P*N key products (counted as Shoup products,
    as K1's bound counts them); bytes: acc in, the exponents, the key rows'
    residues (the Shoup companions are not needed), the partial out."""
    C, P, N = kp.C, kp.P, kp.N
    shoup = butterflies(kp, j_local * P) + j_local * C * P * N
    nbytes = (B * C * N * word_bytes(kp) + B * 4
              + j_local * C * P * N * 4 + B * C * P * N * 4)
    out = ops_bytes_bound(SHOUP_MULTIPLIES * shoup * B, nbytes, max_clock_mhz)
    out["products_per_ciphertext"] = shoup
    return out


def finish_step_bound(kp, B, m, max_clock_mhz):
    """K8b for B ciphertexts on m partials: per ciphertext C*P inverse NTTs
    and one Garner product per word; bytes: the m partials in, acc in and
    out."""
    C, P, N = kp.C, kp.P, kp.N
    shoup = butterflies(kp, C * P) + C * N
    nbytes = m * B * C * P * N * 4 + 2 * B * C * N * word_bytes(kp)
    out = ops_bytes_bound(SHOUP_MULTIPLIES * shoup * B, nbytes, max_clock_mhz)
    out["products_per_ciphertext"] = shoup
    return out


@contextlib.contextmanager
def plain_kernels(pk):
    """Route every kernel wrapper to its plain version for the duration, so
    an entry point runs its plain whole on CUDA tensors."""
    saved = {name: getattr(pk, name) for name in KERNELS}
    for name in KERNELS:
        setattr(pk, name, getattr(pk, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(pk, name, fn)


def zero_counts(pk):
    for name in KERNELS:
        getattr(pk, name).launches = 0
        getattr(pk, name + "_plain").calls = 0


def read_counts(pk):
    counts = {name: getattr(pk, name).launches for name in KERNELS}
    counts.update({name + "_plain": getattr(pk, name + "_plain").calls
                   for name in KERNELS})
    return counts


def check_counts(path, counts, want):
    """Every count zero but those named in ``want``, which must match."""
    full = {name: 0 for name in counts}
    full.update(want)
    if counts != full:
        fail(f"{path}: counts {counts}, want {want} and nothing else")


def random_u64(rs, shape, dev):
    return torch.from_numpy(rs.integers(0, 1 << 64, shape, dtype=np.uint64)
                            .view(np.int64)).to(dev)


def random_u32(rs, shape, dev):
    return torch.from_numpy(rs.integers(0, 1 << 32, shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)


def random_residues_i32(rs, shape, primes, dev):
    """Random canonical residues [..., P, N] as u32 bits in int32."""
    pr = np.array(primes, np.uint64)[:, None]
    r = rs.integers(0, 1 << 62, shape, dtype=np.uint64) % pr
    return torch.from_numpy(r.astype(np.uint32).view(np.int32)).to(dev)


def random_exponents(rs, B, G, M, N, dev):
    """[B, G, M] int32 in [0, 2N] with 0, N and 2N present."""
    rot = rs.integers(0, 2 * N + 1, (B, G, M), dtype=np.int32)
    rot[0, 0, 0], rot[-1, -1, -1], rot[0, -1, M // 2] = 0, 2 * N, N
    return torch.from_numpy(rot).to(dev)


def same_or_fail(what, got, want):
    if not torch.equal(got, want):
        fail(f"{what}: {int((got != want).sum())} words differ")


def sparse_select_sum(dig, ab):
    """The select-sum as one library call, where PyTorch has one: the
    one-hot digits [B, n_in t (base-1)] as a sparse matrix of ab's dtype,
    then torch.sparse.mm by the table rows.  Returns the call (built here,
    outside any timing) and a note; the call is None when the probe raised,
    and the note then says what PyTorch answered."""
    B, n_in, t = dig.shape
    base_m1, width = ab.shape[2], ab.shape[3]
    d = dig.reshape(B, n_in * t).to(torch.int64)
    at = torch.nonzero((d > 0) & (d <= base_m1))
    cols = at[:, 1] * base_m1 + d[at[:, 0], at[:, 1]] - 1
    onehot = torch.sparse_coo_tensor(
        torch.stack([at[:, 0], cols]),
        torch.ones(at.shape[0], dtype=ab.dtype, device=ab.device),
        (B, n_in * t * base_m1)).coalesce()
    rows = ab.reshape(-1, width)
    try:
        torch.sparse.mm(onehot, rows)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, (f"none: torch.sparse.mm of the one-hot digits and the "
                      f"{ab.dtype} table raised \"{str(e).splitlines()[0]}\" "
                      f"(torch {torch.__version__}); embedding_bag takes "
                      f"floating weights only")
    return (lambda: torch.sparse.mm(onehot, rows),
            "torch.sparse.mm of the one-hot digits by the table rows")


def placement(pk, kernel, kp, source=None, **kw):
    """Where ``kernel``'s buffers live at ``kp``'s shape on this card, as
    the wrapper places them: S shared, W workspace, I in place (for K8b's
    second buffer: left out, one pass per component).  ``source``: the
    kernel's csrc file, when it is not ``kernel``."""
    layout, stride = pk.kernel_layout(kernel, kp,
                                      pk._smem_budget(source or kernel, 0),
                                      **kw)
    where = "".join("S" if o >= 0 else "I" if o == -1 else "W"
                    for o in layout[2:])
    return {"where": where, "smem_bytes": int(layout[0]),
            "workspace_bytes_per_block": int(stride)}


def ga_stepwise_phase(bkg, tv, cs, acc_k6, acc_k7, gens, k7_ms, max_clock):
    """Phase 14b: the per-step GA forms on phase 14's GA key, LUT and
    ciphertexts.  blind_rotate_ga_stepwise (n K1-delta and n+1 K6 launches)
    and blind_rotate_ga_gathered (n K1-delta and n+1 K6-old launches, no
    K6), counts zeroed just before each call and read just after, each
    word-equal to phase 14's K7 output ``acc_k7`` and timed warm beside
    blind_rotate_ga and K7 alone; then K1-delta and K6-old alone on the
    path's first step (``acc_k6``: the rotation after psi_{w0}) beside their
    bounds and their plain versions, and K6 on that step's product; then
    the three timed again with their launches queued (`queued_ms`) and on
    the host (microseconds per wrapper call), and each form's device share,
    its kernels' queued ms per launch times its launches per call over the
    warm call's ms.  Returns (report, counts, runs)."""
    from mosfhet_torch import bootstrap, bootstrap_ga
    from mosfhet_torch.ops import pbs_kernel as pk

    n = bkg.n
    tv_r = bootstrap.rotate_test_vector(tv, cs, bkg, 4)
    fused_ms, _ = cuda_ms(
        lambda: bootstrap_ga.blind_rotate_ga(tv_r, cs.a, bkg), STEP_REPS)
    report = {"blind_rotate_ga_ms": fused_ms, "k7_ms": k7_ms}
    counts, runs = {}, {}
    for form, want in (
            ("stepwise", {"cmux_delta": n, "auto_keyswitch_stream": n + 1}),
            ("gathered", {"cmux_delta": n, "auto_keyswitch": n + 1})):
        fn = getattr(bootstrap_ga, f"blind_rotate_ga_{form}")
        zero_counts(pk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(tv_r, cs.a, bkg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts[form] = read_counts(pk)
        check_counts(f"GA {form} form", counts[form], want)
        same_or_fail(f"GA {form} form vs phase 14's K7 output",
                     out.stacked().reshape(acc_k7.shape), acc_k7)
        warm_ms, _ = cuda_ms(lambda: fn(tv_r, cs.a, bkg), STEP_REPS)
        report[form] = {"first_call_s": first_s, "warm_ms": warm_ms,
                        "boot_per_s": BATCH / warm_ms * 1e3,
                        "vs_blind_rotate_ga": warm_ms / fused_ms,
                        "vs_k7": warm_ms / k7_ms, "launches_per_call": want}
        log(f"# blind_rotate_ga_{form} at B={BATCH}, n={n}: first call "
            f"{first_s:.3f} s; warm {warm_ms:.3f} ms (mean of {STEP_REPS}) "
            f"= {BATCH / warm_ms * 1e3:.2f} rotations/s, "
            f"{warm_ms / fused_ms:.4f} x blind_rotate_ga's {fused_ms:.3f} ms "
            f"(K6 + K7), {warm_ms / k7_ms:.4f} x K7's {k7_ms:.3f} ms; "
            f"launches {want}; words equal to K7's")
    kp, kp_ks = bkg.kernel_plans()
    fns = {"cmux_delta": lambda: pk.cmux_delta(acc_k6, bkg.s_v32[0],
                                                bkg.s_vs32[0], kp)}
    t_k = hold(runs, "cmux_delta", fns["cmux_delta"],
               lambda: pk.cmux_delta_plain(acc_k6, bkg.s_v32[0],
                                           bkg.s_vs32[0], kp),
               cmux_delta_bound(kp, BATCH, max_clock), reps=KS_REPS)
    kidx = ((gens[0].to(torch.int64) - 1) >> 1)
    kidx32, ginv = kidx.to(torch.int32), bkg.inv2n[kidx].contiguous()
    fns["auto_keyswitch_stream"] = lambda: pk.auto_keyswitch_stream(
        t_k, bkg.ak, kidx32, ginv, kp_ks)
    o_6 = hold(runs, "auto_keyswitch_stream", fns["auto_keyswitch_stream"],
               lambda: pk.auto_keyswitch_stream_plain(t_k, bkg.ak, kidx32,
                                                      ginv, kp_ks),
               auto_ks_bound(kp_ks, BATCH, kidx, max_clock), reps=KS_REPS)
    perm = bootstrap_ga._permute_dyn(t_k, gens[0], bkg.inv2n,
                                     bkg.N).contiguous()
    rows = bkg.ak[kidx]
    fns["auto_keyswitch"] = lambda: pk.auto_keyswitch(perm, rows, kp_ks)
    o_k = hold(runs, "auto_keyswitch", fns["auto_keyswitch"],
               lambda: pk.auto_keyswitch_plain(perm, rows, kp_ks),
               auto_ks_gathered_bound(kp_ks, BATCH, max_clock),
               reps=KS_REPS)
    same_or_fail("K6-old vs K6 on the path's first step", o_k, o_6)
    for name, fn in fns.items():
        runs[name]["queued_ms"], _ = queued_ms(fn, TP_REPS)
        runs[name]["host_us"] = host_us(fn, TP_REPS)
    for name, what in (("cmux_delta", "K1-delta"),
                       ("auto_keyswitch_stream", "K6"),
                       ("auto_keyswitch", "K6-old")):
        r = runs[name]
        log(f"# {name} ({what}) at B={BATCH} on the path's first step: "
            f"kernel {r['ms']:.4f} ms/launch (mean of {KS_REPS}), plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bound']['int32_ops']:.4g} int32 ops, "
            f"{r['bound']['bytes']:.4g} B; "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it); bit-exact; "
            f"launches queued {r['queued_ms']:.4f} ms (mean of {TP_REPS}); "
            f"host {r['host_us']:.1f} us per wrapper call")
    for form in ("stepwise", "gathered"):
        f = report[form]
        f["device_ms"] = sum(runs[name]["queued_ms"] * launches
                             for name, launches
                             in f["launches_per_call"].items())
        f["device_share"] = f["device_ms"] / f["warm_ms"]
        f["host_ms"] = sum(runs[name]["host_us"] * launches * 1e-3
                           for name, launches
                           in f["launches_per_call"].items())
        log(f"# blind_rotate_ga_{form} device share (an estimate from "
            f"each kernel's first-step time): "
            + " + ".join(f"{launches} x {runs[name]['queued_ms']:.4f} ms "
                         f"{name}"
                         for name, launches in f["launches_per_call"].items())
            + f" = {f['device_ms']:.3f} ms of the warm call's "
            f"{f['warm_ms']:.3f} ms = {100 * f['device_share']:.1f}%; "
            f"wrappers {f['host_ms']:.3f} ms on the host")
    report["k1_delta_residency"] = residency(
        *pk.cmux_delta_residency(kp), f"K1-delta at N={kp.N}, P={kp.P}")
    r = report["k1_delta_residency"]
    log(f"# L2 K1-delta residency: {r['blocks_per_sm']} blocks of "
        f"{r['threads_per_block']} threads per SM "
        f"({r['resident_ciphertexts']} ciphertexts at once)")
    runs["auto_keyswitch"]["placement"] = placement(
        pk, "auto_keyswitch_stream", kp_ks, "auto_keyswitch")
    r = residency(*pk.auto_keyswitch_residency(kp_ks, 64, gathered=True),
                  f"K6-old at N={kp_ks.N}, P={kp_ks.P}")
    runs["auto_keyswitch"]["resident_blocks_per_sm"] = r["blocks_per_sm"]
    log(f"# L2 K6-old residency (K6's gathered instances): "
        f"{r['blocks_per_sm']} blocks "
        f"of {r['threads_per_block']} threads per SM "
        f"({r['resident_ciphertexts']} ciphertexts at once), placement "
        f"{runs['auto_keyswitch']['placement']}")
    del tv_r, t_k, perm, rows, o_k, o_6
    return report, counts, runs


def hold_in_place(runs, name, kernel_fn, plain_fn, acc, bound, reps):
    """A kernel that updates its accumulator in place (timed over reps on a
    scratch copy of ``acc``) and its plain version (once, on another copy),
    word for word, recorded in ``runs[name]``; returns the kernel's
    output on ``acc``'s words."""
    scratch = acc.clone()
    k_ms, _ = cuda_ms(lambda: kernel_fn(scratch), reps)
    got = kernel_fn(acc.clone())
    p_ms, want = cuda_ms(lambda: plain_fn(acc.clone()), 1)
    same_or_fail(f"{name} vs plain", got, want)
    runs[name] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": 0.0,
                  "bound_ms": bound["bound_ms"],
                  "bound_by": bound["bound_by"], "bound": bound}
    return got


def step_bound_ms(kp, B, max_clock):
    """K1-step: K1's bound over one step (one step's key rows and Shoup
    companions read once, acc in and out, the exponents)."""
    return rotation_bound_ms(kp, 1, B, 2 * kp.J * kp.C * kp.P * kp.N * 4,
                             max_clock)


def ptxas_instances(text, match, what):
    """ptxas's registers and spills of every kernel instance in a source's
    build log (nvcc -Xptxas -v) that ``match`` (a mangled entry name's
    line -> dict, or None for another kernel) describes."""
    out, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = match(line)
        elif cur is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            cur["spill_store_bytes"], cur["spill_load_bytes"] = \
                int(m[1]), int(m[2])
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line)[1])
            out.append(cur)
            cur = None
    if not out:
        fail(f"no {what} instance in the ptxas output")
    return out


def k1_ptxas(text):
    """Every instance of K1's and K1-step's kernels in blind_rotate.cu."""
    def match(line):
        m = re.search(r"(blind_rotate_kernel|pbs_step_kernel)ILi(\d)E"
                      r"([mj])Lb([01])ELi(\d+)E", line)
        return None if m is None else {
            "entry": "K1" if m[1] == "blind_rotate_kernel" else "K1-step",
            "P": int(m[2]), "words": "u64" if m[3] == "m" else "u32",
            "all_shared": m[4] == "1", "log_n": int(m[5]) or None}
    return ptxas_instances(text, match, "K1")


def k7_ptxas(text):
    """Every instance of K7's kernel in ga_scan.cu."""
    def match(line):
        m = re.search(r"ga_scan_kernelILi(\d)ELi(\d)E([mj])Lb([01])ELi(\d+)E",
                      line)
        return None if m is None else {
            "entry": "K7", "P": int(m[1]), "P_ks": int(m[2]),
            "words": "u64" if m[3] == "m" else "u32",
            "all_shared": m[4] == "1", "log_n": int(m[5]) or None}
    return ptxas_instances(text, match, "K7")


def k8_ptxas(text):
    """Every instance of K8a's and K8b's kernels in tp_step.cu (K8b's flag:
    one pass over all C*P rows in shared memory)."""
    def match(line):
        m = re.search(r"(partial_step_kernel|finish_step_kernel)ILi(\d)E"
                      r"([mj])Lb([01])ELi(\d+)E", line)
        return None if m is None else {
            "entry": "K8a" if m[1] == "partial_step_kernel" else "K8b",
            "P": int(m[2]), "words": "u64" if m[3] == "m" else "u32",
            "all_shared": m[4] == "1", "log_n": int(m[5]) or None}
    return ptxas_instances(text, match, "K8")


def sched_ptxas(text, kernel, tag):
    """Every instance of K3's kernel (``kernel`` ext_product_apply, which
    K3-step launches too), K4's (unfolded_rotate), K1-delta's (cmux_delta,
    u64 words only: no word type among its template arguments) or K6's
    (auto_keyswitch), logged as ``tag``; K6's gathered instances, which
    K6-old launches (a last template argument true), as ``tag``-old."""
    def match(line):
        m = re.search(kernel + r"_kernelILi(\d)E([mj]?)Lb([01])ELi(\d+)E"
                      r"(?:Lb([01])E)?E", line)
        return None if m is None else {
            "entry": tag + ("-old" if m[5] == "1" else ""), "P": int(m[1]),
            "words": "u32" if m[2] == "j" else "u64",
            "all_shared": m[3] == "1", "log_n": int(m[4]) or None}
    return ptxas_instances(text, match, tag)


def k2_k5_ptxas(k2_text, k5_text):
    """Every instance of K2's kernel in tlwe_keyswitch.cu (one per word
    type) and of K5's in ubr_phase1.cu (which K5-v1 launches too)."""
    def k2(line):
        m = re.search(r"tlwe_keyswitch_sum_kernelI([mj])E", line)
        return None if m is None else {
            "entry": "K2", "P": None, "words": "u64" if m[1] == "m" else "u32",
            "all_shared": True, "log_n": None}

    return ptxas_instances(k2_text, k2, "K2") + k5_ptxas(k5_text)


def k5_ptxas(text):
    """Every instance of K5's kernel in ubr_phase1.cu (which K5-v1 launches
    too); a LogN template argument where the source has one."""
    def match(line):
        m = re.search(r"ubr_phase1_kernelILi(\d)E([mj])(?:Li(\d+)E)?E", line)
        return None if m is None else {
            "entry": "K5", "P": int(m[1]),
            "words": "u64" if m[2] == "m" else "u32", "all_shared": True,
            "log_n": int(m[3] or 0) or None}
    return ptxas_instances(text, match, "K5")


def log_build(entries):
    for e in entries:
        # K1-step: K1, K8a: K8; K1-delta and K6-old keep their own tags
        tag = re.match(r"K\d+(-delta|-old)?", e["entry"])[0]
        log(f"# {tag} build: {e['entry']}"
            f"{'' if e['P'] is None else ' P=' + str(e['P'])}"
            f"{' P_ks=' + str(e['P_ks']) if 'P_ks' in e else ''} "
            f"{e['words']} {'all shared' if e['all_shared'] else 'placed'}"
            f"{', N=2^' + str(e['log_n']) if e['log_n'] else ''}: "
            f"{e['registers']} registers, {e['spill_store_bytes']} B spill "
            f"stores, {e['spill_load_bytes']} B spill loads")


def residency(blocks, threads, what):
    """One kernel's resident blocks per SM on this card, its threads per
    block and the ciphertexts the card holds at once (one wave)."""
    if blocks < 1:
        fail(f"{what}: no block fits an SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"blocks_per_sm": blocks, "threads_per_block": threads,
            "resident_ciphertexts": blocks * sms}


def k1_residency(pk, kp, bits):
    """K1's and K1-step's residency at ``kp``'s shape (the CUDA occupancy
    query)."""
    return {name: residency(*pk.rotation_residency(kp, bits, step),
                            f"{name} at N={kp.N}, P={kp.P}")
            for name, step in (("K1", False), ("K1-step", True))}


def k7_residency(pk, kp, kp_ks, bits):
    """K7's residency at the two plans' shape (the CUDA occupancy query)."""
    return residency(*pk.ga_scan_residency(kp, kp_ks, bits),
                     f"K7 at N={kp.N}, P={kp.P}, P_ks={kp_ks.P}")


def k6_residency(pk, kp_ks, bits, tag):
    """K6's residency at the key-switch plan's shape (the CUDA occupancy
    query), logged under ``tag``."""
    r = residency(*pk.auto_keyswitch_residency(kp_ks, bits),
                  f"K6 at N={kp_ks.N}, P={kp_ks.P}")
    log(f"# {tag} K6 residency: {r['blocks_per_sm']} blocks of "
        f"{r['threads_per_block']} threads per SM "
        f"({r['resident_ciphertexts']} ciphertexts at once), placement "
        f"{placement(pk, 'auto_keyswitch_stream', kp_ks, 'auto_keyswitch')}")
    return r


def k3_k4_residency(pk, kp, bits, M, tag):
    """K3's and K4's residency at ``kp``'s shape (K4 with M = 2^u
    exponents; the CUDA occupancy query), logged under ``tag``."""
    r = {"K3": residency(*pk.ext_product_apply_residency(kp, bits),
                         f"K3 at N={kp.N}, P={kp.P}"),
         "K4": residency(*pk.unfolded_rotate_residency(kp, bits, M),
                         f"K4 at N={kp.N}, P={kp.P}, M={M}")}
    log(f"# {tag} K3/K4 residency: " + "; ".join(
        f"{name} {x['blocks_per_sm']} blocks of {x['threads_per_block']} "
        f"threads per SM ({x['resident_ciphertexts']} ciphertexts at once)"
        for name, x in r.items()))
    return r


def k3_alone_ms(pk, c, g, kp, per_row):
    """K3 alone on `trgsw.external_product`'s inputs (the stacked TRLWEs
    and the TRGSW's residues as int32, as that entry point builds them):
    ms per launch, the entry point's glue left out."""
    x = c.stacked().contiguous()
    rows = (1, x.shape[0]) if per_row else (1,)
    sa = pk.u32_as_i32(g.v).reshape(rows + tuple(g.v.shape[-4:])).contiguous()
    return cuda_ms(lambda: pk.ext_product_apply_scan(x, sa, kp, per_row),
                   REPS)[0]


def unfolded_l2_traffic(kp, B, G, M, k4_ms):
    """The key-product words K4's blocks read through L2 in one call
    (every block reads every word of every group once: B G M J C N words)
    and the rate they imply at K4's time."""
    nbytes = B * G * M * kp.J * kp.C * kp.N * word_bytes(kp)
    return {"l2_bytes": nbytes, "l2_bytes_per_s": nbytes / (k4_ms * 1e-3)}


def k8_residency(pk, kp, bits, tag):
    """K8a's and K8b's residency at ``kp``'s shape (the CUDA occupancy
    query), logged under ``tag``."""
    r = {name: residency(*pk.tp_step_residency(kp, bits, kernel),
                         f"{name} at N={kp.N}, P={kp.P}")
         for name, kernel in (("K8a", "partial_step"),
                              ("K8b", "finish_step"))}
    log(f"# {tag} K8 residency: " + "; ".join(
        f"{name} {x['blocks_per_sm']} blocks of {x['threads_per_block']} "
        f"threads per SM ({x['resident_ciphertexts']} ciphertexts at once)"
        for name, x in r.items()))
    return r


def host_us(fn, reps):
    """Host microseconds per call of ``fn``, a wrapper that only enqueues a
    launch: from the first call to the last one's return, the card's queue
    empty at the start."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def sharded_share(pk, bk, kp, acc_in, a_int, data, model, warm_ms):
    """A (data, model) mesh's sharded path at its first step's shapes (one
    data row's ciphertexts, J/model key rows per shard, model partials):
    K8a and K8b timed on the card (`queued_ms`) and on the host (`host_us`)
    and the path's device share, n data (model K8a + K8b) ms over the warm
    call's ms.  The rest of the warm call is the card waiting for the host
    or for the glue."""
    Bs, jl = acc_in.shape[0] // data, kp.J // model
    acc, a = acc_in[:Bs].contiguous(), a_int[0, :Bs].contiguous()
    shards = [(acc, a, s * jl, bk.v32[0, s * jl:(s + 1) * jl].contiguous(),
               bk.vs32[0, s * jl:(s + 1) * jl].contiguous(), kp)
              for s in range(model)]
    parts = torch.empty((model, Bs, kp.C, kp.P, kp.N), dtype=torch.int32,
                        device=acc.device)
    for s, args in enumerate(shards):
        pk.partial_step(*args, out=parts[s])
    acc_f = acc.clone()
    out = {"ciphertexts": Bs, "key_rows": jl}
    for name, fn in (
            ("k8a", lambda: pk.partial_step(*shards[0], out=parts[0])),
            ("k8b", lambda: pk.finish_step(acc_f, parts, kp))):
        out[name + "_ms"], _ = queued_ms(fn, TP_REPS)
        out[name + "_host_us"] = host_us(fn, TP_REPS)
    step_ms = model * out["k8a_ms"] + out["k8b_ms"]
    out["device_ms"] = bk.n * data * step_ms
    out["device_share"] = out["device_ms"] / warm_ms
    out["host_us_per_step"] = data * (model * out["k8a_host_us"]
                                      + out["k8b_host_us"])
    out["device_us_per_step"] = data * step_ms * 1e3
    return out


def log_share(tag, name, r):
    log(f"# {tag} {name} device share: K8a {r['k8a_ms']:.4f} ms and K8b "
        f"{r['k8b_ms']:.4f} ms at B={r['ciphertexts']}, {r['key_rows']} key "
        f"rows; kernels {r['device_ms']:.3f} ms of the warm call = "
        f"{100 * r['device_share']:.1f}%; host {r['k8a_host_us']:.1f} us per "
        f"K8a and {r['k8b_host_us']:.1f} us per K8b launch, "
        f"{r['host_us_per_step']:.1f} us of wrappers per step against "
        f"{r['device_us_per_step']:.1f} us of kernels")


def wave_curve(run, acc_in, per_ct, resident):
    """run(acc, per_ct) on the first B of a path's ciphertexts (the first
    ones again past the batch) for B in WAVE_BATCHES: ms and ms per
    ciphertext.  per_ct [., batch]: the per-ciphertext exponents or
    generators of every step."""
    curve = []
    for B in WAVE_BATCHES:
        idx = torch.arange(B, device=acc_in.device) % acc_in.shape[0]
        acc_b = acc_in[idx].contiguous()
        x_b = per_ct[:, idx].contiguous()
        ms, _ = cuda_ms(lambda: run(acc_b, x_b), STEP_REPS)
        curve.append({"batch": B, "ms": ms, "ms_per_ciphertext": ms / B,
                      "waves": -(-B // resident)})
    del acc_b, x_b
    return curve


def log_wave_curve(tag, name, r, curve, note=""):
    log(f"# {tag} {name} residency: {r['blocks_per_sm']} blocks of "
        f"{r['threads_per_block']} threads per SM ({r['resident_ciphertexts']} "
        f"ciphertexts at once{note}); wave curve: "
        + ", ".join(f"B={c['batch']} {c['ms']:.3f} ms "
                    f"({c['ms_per_ciphertext']:.4f}/ct, {c['waves']} waves)"
                    for c in curve))


def rotation_steps_phase(bk, tv, cs, acc_k, k1_ms, max_clock):
    """Phase 4b (and its L2_32 counterpart in phase 20): the per-step
    rotation on a path's key, LUT and ciphertexts.  blind_rotate_stepwise,
    counts zeroed just before the call and read just after (n K1-step
    launches and nothing else), word-equal to the path's K1 output
    ``acc_k`` and timed warm beside blind_rotate; then K1-step alone on the
    path's first step beside its bound and its plain version (bit-exact);
    and both forms on one wave of the path's ciphertexts (as many as the
    card keeps resident at once), which tells the fused loop's cost from
    the waves'.  Returns (report, counts, runs)."""
    from mosfhet_torch import bootstrap
    from mosfhet_torch.ops import pbs_kernel as pk

    n, B = bk.n, acc_k.shape[0]
    tv_r = bootstrap.rotate_test_vector(tv, cs, bk, 4)
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bootstrap.blind_rotate_stepwise(tv_r, cs.a, bk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts(pk)
    check_counts("blind_rotate_stepwise", counts, {"pbs_step": n})
    same_or_fail("blind_rotate_stepwise vs the path's K1 output",
                 out.stacked().reshape(acc_k.shape), acc_k)
    fused_ms, _ = cuda_ms(lambda: bootstrap.blind_rotate(tv_r, cs.a, bk),
                          STEP_REPS)
    warm_ms, _ = cuda_ms(
        lambda: bootstrap.blind_rotate_stepwise(tv_r, cs.a, bk), STEP_REPS)
    acc_in, a_int, _ = bootstrap.blind_rotate_inputs(tv_r, cs.a, bk)
    kp = bk.kernel_plan()
    runs = {}
    hold_in_place(runs, "pbs_step",
                  lambda acc: pk.pbs_step(acc, a_int[0], bk.v32[0],
                                          bk.vs32[0], kp),
                  lambda acc: pk.pbs_step_plain(acc, a_int[0], bk.v32[0],
                                                bk.vs32[0], kp),
                  acc_in, step_bound_ms(kp, B, max_clock), KS_REPS)
    r = runs["pbs_step"]
    resident = k1_residency(pk, kp, kp.torus_bits)["K1"]
    wave = min(B, resident["resident_ciphertexts"])
    acc_w, a_w = acc_in[:wave].contiguous(), a_int[:, :wave].contiguous()

    def steps_w():
        acc = acc_w.clone()
        for i in range(n):
            pk.pbs_step(acc, a_w[i], bk.v32[i], bk.vs32[i], kp)
        return acc

    wave_k1_ms, acc_f = cuda_ms(
        lambda: pk.blind_rotate_scan(acc_w, a_w, bk.v32, bk.vs32, kp),
        STEP_REPS)
    wave_steps_ms, acc_s = cuda_ms(steps_w, STEP_REPS)
    same_or_fail("one wave: K1-step x n vs K1", acc_s, acc_f)
    report = {"batch": B, "n": n, "first_call_s": first_s,
              "warm_ms": warm_ms, "blind_rotate_ms": fused_ms,
              "vs_blind_rotate": warm_ms / fused_ms, "k1_ms": k1_ms,
              "vs_k1": warm_ms / k1_ms, "launches_per_call": {"pbs_step": n},
              "k1_step_ms_x_n": r["ms"] * n,
              "one_wave": {"batch": wave,
                           "blocks_per_sm": resident["blocks_per_sm"],
                           "k1_ms": wave_k1_ms,
                           "k1_step_x_n_ms": wave_steps_ms,
                           "steps_vs_k1": wave_steps_ms / wave_k1_ms}}
    log(f"# blind_rotate_stepwise at B={B}, n={n}: first call {first_s:.3f} "
        f"s; warm {warm_ms:.3f} ms (mean of {STEP_REPS}) = "
        f"{B / warm_ms * 1e3:.2f} rotations/s, {warm_ms / fused_ms:.4f} x "
        f"blind_rotate's {fused_ms:.3f} ms, {warm_ms / k1_ms:.4f} x K1's "
        f"{k1_ms:.3f} ms; {n} K1-step launches; words equal to K1's; "
        f"K1-step {r['ms']:.4f} ms/launch on the first step (mean of "
        f"{KS_REPS}), plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}); bit-exact; one wave "
        f"(B={wave}): {n} K1-step launches {wave_steps_ms:.3f} ms, K1 "
        f"{wave_k1_ms:.3f} ms ({wave_steps_ms / wave_k1_ms:.4f} x)")
    del tv_r, out, acc_in, a_int, acc_w, a_w, acc_f, acc_s
    return report, counts, runs


def ubr_steps_phase(bk, c1, tvs, sa, out_u, k5_ms, k3_ms, max_clock):
    """Phase 11b (and its L2_32 counterpart in phase 20): UBR phase 1
    through K5-v1 and phase 2 one cached group per launch (K3-step) on a
    UBR path's key, ciphertext, LUTs, cache ``sa`` and output ``out_u``.
    Counts zeroed just before each call and read just after: 1 K5-v1
    launch, n/u K3-step launches, nothing else; words equal to K5's cache
    and the fused phase 2's; K5-v1 timed on the path's inputs beside K5
    and its plain version, the step form warm beside the fused phase 2,
    K3-step alone on the first group beside its plain version.  Returns
    (report, counts, runs)."""
    from mosfhet_torch import bootstrap
    from mosfhet_torch.ops import pbs_kernel as pk

    kp = bk.kernel_plan()
    G, M = bk.su.shape[0], bk.su.shape[1]
    luts = tvs.b.shape[0]
    counts, runs = {}, {}
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa_v1 = bootstrap.multivalue_bootstrap_UBR_phase1_v1(c1, bk)
    torch.cuda.synchronize()
    v1_first_s = time.perf_counter() - t0
    counts["ubr_phase1_v1"] = read_counts(pk)
    check_counts("UBR phase 1 v1", counts["ubr_phase1_v1"],
                 {"ubr_phase1_combine_v1": 1})
    same_or_fail("UBR phase 1 v1 vs K5's cache", sa_v1.v, sa.v)
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_s = bootstrap.multivalue_bootstrap_UBR_phase2_stepwise(tvs, c1, sa,
                                                               bk, 4)
    torch.cuda.synchronize()
    step_first_s = time.perf_counter() - t0
    counts["ubr_phase2_steps"] = read_counts(pk)
    check_counts("UBR phase 2 step form", counts["ubr_phase2_steps"],
                 {"ext_product_apply_step": G})
    same_or_fail("UBR phase 2 step form vs phase 2 (a)", out_s.a, out_u.a)
    same_or_fail("UBR phase 2 step form vs phase 2 (b)", out_s.b, out_u.b)
    rot, _ = bootstrap.ubr_phase1_inputs(c1, bk)
    hold(runs, "ubr_phase1_combine_v1",
         lambda: pk.ubr_phase1_combine_v1(bk.su, rot, kp),
         lambda: pk.ubr_phase1_combine_v1_plain(bk.su, rot, kp),
         ubr_phase1_bound(kp, 1, G, M, max_clock), K5_REPS, queued_ms)
    k5_same_ms, _ = k5_time(pk.ubr_phase1_combine, bk.su, rot, kp)
    runs["ubr_phase1_combine_v1"].update({
        "kernel_of": "ubr_phase1_combine", "k5_ms": k5_same_ms})
    fused_ms, _ = cuda_ms(lambda: bootstrap.multivalue_bootstrap_UBR_phase2(
        tvs, c1, sa, bk, 4), STEP_REPS)
    warm_ms, _ = cuda_ms(
        lambda: bootstrap.multivalue_bootstrap_UBR_phase2_stepwise(
            tvs, c1, sa, bk, 4), STEP_REPS)
    acc_u, sa32, per_row, _ = bootstrap.ubr_phase2_inputs(tvs, c1, sa, bk, 4)
    hold_in_place(runs, "ext_product_apply_step",
                  lambda acc: pk.ext_product_apply_step(acc, sa32[0], kp,
                                                        per_row),
                  lambda acc: pk.ext_product_apply_step_plain(
                      acc, sa32[0], kp, per_row),
                  acc_u, apply_scan_bound(kp, luts, 1, per_row, max_clock),
                  KS_REPS)
    v1, k3s = runs["ubr_phase1_combine_v1"], runs["ext_product_apply_step"]
    k3s["placement"] = placement(pk, "ext_product_apply", kp)
    r = residency(*pk.ext_product_apply_residency(kp, kp.torus_bits),
                  f"K3-step at N={kp.N}, P={kp.P}")
    k3s["resident_blocks_per_sm"] = r["blocks_per_sm"]
    log(f"# K3-step residency (K3's kernel, {kp.torus_bits}-bit words): "
        f"{r['blocks_per_sm']} blocks of {r['threads_per_block']} threads "
        f"per SM ({r['resident_ciphertexts']} ciphertexts at once), "
        f"placement {k3s['placement']}")
    report = {"unfolding": bk.unfolding, "luts": luts,
              "phase1_v1_first_ms": v1_first_s * 1e3,
              "phase1_v1_ms": v1["ms"], "phase1_k5_ms": k5_ms,
              "phase1_k5_same_inputs_ms": k5_same_ms,
              "phase1_v1_vs_k5": v1["ms"] / k5_ms,
              "phase2_steps_first_ms": step_first_s * 1e3,
              "phase2_steps_ms": warm_ms, "phase2_fused_ms": fused_ms,
              "phase2_k3_ms": k3_ms,
              "phase2_steps_vs_fused": warm_ms / fused_ms,
              "phase2_steps_ms_per_lut": warm_ms / luts,
              "phase2_fused_ms_per_lut": fused_ms / luts,
              "k3_step_ms_x_g": k3s["ms"] * G}
    log(f"# UBR v1 and step forms (u={bk.unfolding}, G={G}, M={M}): phase 1 "
        f"v1 first call {v1_first_s * 1e3:.3f} ms (1 K5-v1 launch counted, "
        f"K5's kernel), K5-v1 {v1['ms']:.3f} ms/launch = "
        f"{v1['ms'] / k5_ms:.3f} x K5's {k5_ms:.3f} (K5 on the same inputs "
        f"in this phase {k5_same_ms:.3f}; plain "
        f"{v1['plain_ms']:.3f}, bound {v1['bound_ms']:.4f} {v1['bound_by']}); "
        f"phase 2 step form of {luts} LUTs first call "
        f"{step_first_s * 1e3:.3f} ms, warm {warm_ms:.3f} ms = "
        f"{warm_ms / luts:.4f} ms per LUT, {warm_ms / fused_ms:.4f} x the "
        f"fused phase 2's {fused_ms:.3f} ms ({fused_ms / luts:.4f} per LUT; "
        f"K3 {k3_ms:.3f}); K3-step {k3s['ms']:.4f} ms/launch on the first "
        f"group (plain {k3s['plain_ms']:.3f}, bound {k3s['bound_ms']:.4f} "
        f"{k3s['bound_by']}); words equal to K5's and phase 2's; bit-exact")
    del sa_v1, out_s, acc_u, sa32, rot
    return report, counts, runs


def k5_batches(pk, N, bits):
    """Phase 9's batches for K5 and K5-v1 at row length N and ``bits``-bit
    words: one ciphertext, a tile less one, a tile, a tile plus one and
    K5_BATCH."""
    tile = pk.ubr_phase1_tiling(K5_BATCH, N, bits)["tile"]
    return sorted({1, tile - 1, tile, tile + 1, K5_BATCH})


def k5_time(fn, su, rot, kp):
    """Milliseconds per launch of K5 (or of K5-v1, ``fn``) on these
    operands, warm: K5_REPS launches queued (`queued_ms`: at L2_32 and one
    ciphertext the host's time per call is near K5's own).  Every phase
    and `--k5` time K5 so.  Returns the last result too."""
    return queued_ms(lambda: fn(su, rot, kp), K5_REPS)


def smem_ceiling_ms(kp, B, G, M, max_clock_mhz):
    """K5's shared-memory ceiling, derived from its design, not measured:
    each staged rotate-add reads one word of shared memory (8 B, 4 at the
    32-bit torus), B G M J C N of them, at SMEM_BYTES_PER_CLOCK per SM and
    clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nbytes = B * G * M * kp.J * kp.C * kp.N * word_bytes(kp)
    return 1e3 * nbytes / (sms * SMEM_BYTES_PER_CLOCK * max_clock_mhz * 1e6)


def k5_batch_phase(bk, c, max_clock, tag):
    """UBR phase 1 of the ciphertexts ``c`` (phases 11 and 20, K5_BATCH of
    them): multivalue_bootstrap_UBR_phase1 with the counts zeroed just
    before and read just after (exactly 1 K5 launch), then warm; K5 alone
    on its exponents, timed beside its bound and its shared-memory ceiling,
    its words the call's, and the first two and the last ciphertext held to
    the plain version (each ciphertext's words are independent of the
    others'); K5's schedule (tile, tiles, stages, shared bytes) and resident
    blocks per SM at this batch and at one ciphertext.  Returns (report,
    counts)."""
    from mosfhet_torch import bootstrap
    from mosfhet_torch.ops import pbs_kernel as pk

    kp = bk.kernel_plan()
    B, G, M = c.a.shape[0], bk.su.shape[0], bk.su.shape[1]
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = bootstrap.multivalue_bootstrap_UBR_phase1(c, bk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts(pk)
    check_counts(f"{tag} UBR phase 1 of {B}", counts,
                 {"ubr_phase1_combine": 1})
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    warm_ms, _ = cuda_ms(
        lambda: bootstrap.multivalue_bootstrap_UBR_phase1(c, bk), REPS)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    rot, _ = bootstrap.ubr_phase1_inputs(c, bk)
    k5_ms, got = k5_time(pk.ubr_phase1_combine, bk.su, rot, kp)
    same_or_fail(f"{tag} UBR phase 1 of {B} vs K5's words",
                 pk.i32_as_u32(got), sa.v)
    pick = torch.tensor([0, 1, B - 1], device=rot.device)
    plain_ms, want = cuda_ms(lambda: pk.ubr_phase1_combine_plain(
        bk.su, rot[pick].contiguous(), kp), 1)
    same_or_fail(f"{tag} K5 at B={B} vs plain on ciphertexts 0, 1, {B - 1}",
                 got[pick], want)
    bound = ubr_phase1_bound(kp, B, G, M, max_clock)
    ceiling = smem_ceiling_ms(kp, B, G, M, max_clock)
    budget = pk._smem_budget("ubr_phase1", torch.cuda.current_device())
    shape = {}
    for b in (1, B):
        sc = pk.ubr_phase1_schedule(kp, b, M, budget)
        blocks, threads = pk.ubr_phase1_residency(kp, kp.torus_bits, b, M)
        shape[b] = {"tile": sc["tile"], "tiles": sc["tiles"],
                    "stages": sc["stages"],
                    "smem_bytes": int(sc["layout"][0]),
                    "blocks_per_sm": blocks, "threads_per_block": threads}
    report = {"batch": B, "first_call_ms": first_s * 1e3,
              "phase1_warm_ms": warm_ms, "warm_alloc_retries": retries,
              "k5_ms": k5_ms,
              "k5_ms_per_ciphertext": k5_ms / B,
              "plain_ms_3_ciphertexts": plain_ms, "bound": bound,
              "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
              "smem_ceiling_ms": ceiling, "schedule": shape}
    log(f"# {tag} K5 at B={B} (G={G}, M={M}): UBR phase 1 first call "
        f"{first_s * 1e3:.3f} ms (1 K5 launch counted), warm {warm_ms:.3f} "
        f"ms ({retries} allocator retries); K5 {k5_ms:.4f} ms/launch = {k5_ms / B:.5f} ms per ciphertext,"
        f" bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
        f"{100 * bound['bound_ms'] / k5_ms:.1f}% of it), shared-memory "
        f"ceiling {ceiling:.4f} ms (derived, not measured); plain on "
        f"ciphertexts 0, 1, {B - 1} {plain_ms:.3f} ms, bit-exact; schedule "
        + "; ".join(f"B={b}: tile {x['tile']} x {x['tiles']} tiles, "
                    f"{x['stages']} stages, {x['smem_bytes']} B, "
                    f"{x['blocks_per_sm']} blocks of "
                    f"{x['threads_per_block']} threads per SM"
                    for b, x in shape.items()))
    del sa, got, want, rot
    return report, counts


def step_entries(runs, by_path, tag=""):
    """The kernels-line entries of K1-step, K3-step and K5-v1: their runs
    on the paths' inputs and their launches by path (``tag`` names the
    torus width: "" or "/torus32")."""
    entries = []
    for name, (source, line, note) in STEP_KERNELS.items():
        r, by = runs[name], {path: n for path, n in by_path(name).items()
                             if n}
        if not by:
            fail(f"{name}{tag} was launched no time on its paths")
        entries.append({
            "name": name + tag, "route": "cuda",
            "source": f"mosfhet_torch/ops/csrc/{source}",
            "replaces": f"mosfhet_tpu/ops/pbs_kernel.py:{line}",
            "launches": sum(by.values()), "launches_by_path": by,
            "max_abs_err": r["max_abs_err"], "bit_exact": True,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "library_note": note})
        entries[-1].update({key: r[key] for key in
                            ("placement", "resident_blocks_per_sm",
                             "kernel_of", "k5_ms")
                            if key in r})
    return entries


def trgsw_matrix_phase(p, gk, gen, dev, max_clock, tag):
    """Phase 21 (and its L2_32 counterpart in the phase-20 child): the
    matrix ops `trgsw_mul` and `trgsw_reg_sub` on the port's TRGSW key
    ``gk`` (``tag`` "L2" or "L2_32").  (a) TRGSW(X^5) x TRGSW(X^3) through
    mul_trgsw_dft decrypts to 8; (b) reg_sub of registers of 9 and 4
    decrypts to 5 and N - 5, reg_add to 13 and N - 13; (c) BATCH pairs of
    random exponents (0, N and 2N - 1 present) built with the batched
    monomial_encrypt and to_dft, every mul_trgsw_dft output decrypting to
    (e1 + e2) mod N and every reg_sub half to its difference's index; counts
    zeroed before (a) and read after (c): one K3 launch per
    debug_decrypt_exp_dft and nothing else.  Warm ms of mul_trgsw_dft,
    reg_sub and debug_decrypt_exp_dft on the batch (one call before timing)
    and the peak device memory; (d) the plain PyTorch ops' words on the
    first 4 rows equal to the same calls on CPU tensors; (e) K3 against its
    plain version on debug_decrypt_exp_dft's inputs, timed beside its
    bound.  Returns the report and the path's counts."""
    from mosfhet_torch import ntt, polynomial, torus, trgsw
    from mosfhet_torch.ops import pbs_kernel as pk

    N, k = p.N, p.k
    plan = gk.plan()
    exp = trgsw.debug_decrypt_exp_dft
    ones = torch.ones(BATCH, dtype=torch.int64, device=dev)
    rs = np.random.default_rng(SEED)
    e1_np = rs.integers(0, 2 * N, BATCH)
    e2_np = rs.integers(0, 2 * N, BATCH)
    e1_np[:3], e2_np[:3] = [0, N, 2 * N - 1], [0, N - 1, 2 * N - 1]
    e1, e2 = (torch.from_numpy(e).to(dev) for e in (e1_np, e2_np))
    zero_counts(pk)
    # (a) trgsw_mul as the matrix runs it
    g1 = trgsw.monomial_encrypt(1, 5, gk, gen)
    g2 = trgsw.monomial_encrypt(1, 3, gk, gen)
    got = int(exp(trgsw.mul_trgsw_dft(g1, trgsw.to_dft(g2, plan)), gk))
    if got != 8:
        fail(f"{tag} trgsw_mul: exponent {got}, want 8")
    # (b) trgsw_reg_sub, and reg_add
    r1, r2 = (trgsw.reg_encrypt(m, gk, gen) for m in (9, 4))
    for name, fn, m in (("reg_sub", trgsw.reg_sub, 5),
                        ("reg_add", trgsw.reg_add, 13)):
        r = fn(r1, r2)
        got = (int(exp(r.positive, gk)), int(exp(r.negative, gk)))
        if got != (m, N - m):
            fail(f"{tag} {name}: exponents {got}, want {(m, N - m)}")
    # (c) a batch of pairs, operands built as reg_encrypt builds one
    torch.cuda.reset_peak_memory_stats()
    G1 = trgsw.monomial_encrypt(ones, e1, gk, gen)
    R1 = trgsw.TRGSWReg(
        trgsw.to_dft(G1, plan),
        trgsw.to_dft(trgsw.monomial_encrypt(ones, -e1, gk, gen), plan))
    R2 = trgsw.TRGSWReg(*(trgsw.to_dft(trgsw.monomial_encrypt(
        ones, e, gk, gen), plan) for e in (e2, -e2)))
    prod = trgsw.mul_trgsw_dft(G1, R2.positive)
    sub = trgsw.reg_sub(R1, R2)
    got = [exp(g, gk) for g in (prod, sub.positive, sub.negative)]
    torch.cuda.synchronize()
    counts = read_counts(pk)
    check_counts(f"{tag} trgsw matrix ops", counts,
                 {"ext_product_apply_scan": 8})
    for what, g, want in (("mul_trgsw_dft", got[0], (e1 + e2) % N),
                          ("reg_sub +", got[1], (e1 - e2) % (2 * N) % N),
                          ("reg_sub -", got[2], (e2 - e1) % (2 * N) % N)):
        bad = int((g.to(torch.int64) != want).sum())
        if bad:
            fail(f"{tag} {what} on {BATCH} pairs: {bad} exponents wrong")
    timed = {}
    for name, fn in (("mul_trgsw_dft",
                      lambda: trgsw.mul_trgsw_dft(G1, R2.positive)),
                     ("reg_sub", lambda: trgsw.reg_sub(R1, R2)),
                     ("debug_decrypt_exp_dft", lambda: exp(prod, gk))):
        fn()
        timed[name] = cuda_ms(fn, REPS)[0]
    peak = torch.cuda.max_memory_allocated()
    zero_counts(pk)
    exp(prod, gk)
    torch.cuda.synchronize()
    per_call = read_counts(pk)["ext_product_apply_scan"]
    if per_call != 1:
        fail(f"{tag} debug_decrypt_exp_dft: {per_call} K3 launches, want 1")
    # (d) the plain PyTorch ops against the same calls on CPU tensors
    cpu = torch.device("cpu")
    d2_cpu = trgsw.TRGSWDFT(R2.positive.v[:4].cpu(),
                            R2.positive.vs[:4].cpu(), p.l, p.Bg_bit,
                            plan.primes)
    prod_cpu = trgsw.mul_trgsw_dft(
        trgsw.TRGSW(G1.rows[:4].cpu(), p.l, p.Bg_bit), d2_cpu)
    same_or_fail(f"{tag} mul_trgsw_dft on the card vs the CPU",
                 prod.v[:4].cpu(), prod_cpu.v)
    back = trgsw.from_dft(prod).rows
    same_or_fail(f"{tag} from_dft on the card vs the CPU", back[:4].cpu(),
                 trgsw.from_dft(prod_cpu).rows)
    a, b = G1.rows[:4, p.l, -1], back[:4, p.l, -1]
    wide = ntt.get_plan(N, ntt.TENSOR_PRIMES, dev)
    wide_cpu = ntt.get_plan(N, ntt.TENSOR_PRIMES, cpu)
    same_or_fail(f"{tag} ntt_mul on the card vs the CPU",
                 polynomial.ntt_mul(a, b, wide).cpu(),
                 polynomial.ntt_mul(a.cpu(), b.cpu(), wide_cpu))
    for bit_scale in (0, 32, 64):
        same_or_fail(f"{tag} full_mul_with_scale({bit_scale}) on the card "
                     f"vs the CPU",
                     polynomial.full_mul_with_scale(a, b, bit_scale,
                                                    wide).cpu(),
                     polynomial.full_mul_with_scale(a.cpu(), b.cpu(),
                                                    bit_scale, wide_cpu))
    # (e) K3 against its plain version on debug_decrypt_exp_dft's inputs
    kp = pk.get_kernel_plan(N, plan.primes, p.l, p.Bg_bit, k, dev,
                            torus.word_bits(G1.rows))
    h = torch.zeros(BATCH, k + 1, N, dtype=G1.rows.dtype, device=dev)
    h[:, k, 0] = torus.to_signed(1 << (torus.TORUS_BITS - p.Bg_bit))
    sa = pk.u32_as_i32(prod.v).reshape((1, BATCH) + tuple(prod.v.shape[1:]))
    sa = sa.contiguous()
    k3_ms, k3_out = cuda_ms(
        lambda: pk.ext_product_apply_scan(h, sa, kp, True), REPS)
    k3_plain_ms, k3_want = cuda_ms(
        lambda: pk.ext_product_apply_scan_plain(h, sa, kp, True), 1)
    same_or_fail(f"{tag} K3 vs plain on debug_decrypt_exp_dft's inputs",
                 k3_out, k3_want)
    k3_bound = apply_scan_bound(kp, BATCH, 1, True, max_clock)
    del G1, R1, R2, prod, sub, back, sa, h, k3_out, k3_want
    report = {"batch": BATCH, **{f"{name}_ms": ms
                                 for name, ms in timed.items()},
              "peak_bytes": peak, "k3_launches_per_decrypt": per_call,
              "k3_ms": k3_ms, "k3_plain_ms": k3_plain_ms,
              "k3_bound_ms": k3_bound["bound_ms"],
              "k3_bound_by": k3_bound["bound_by"]}
    log(f"# {tag} trgsw matrix ops: trgsw_mul 8, reg_sub 5 and N-5, "
        f"reg_add 13 and N-13; {BATCH} pairs: every exponent right; warm "
        f"mul_trgsw_dft {timed['mul_trgsw_dft']:.3f} ms, reg_sub "
        f"{timed['reg_sub']:.3f} ms, debug_decrypt_exp_dft "
        f"{timed['debug_decrypt_exp_dft']:.3f} ms ({per_call} K3 launch per "
        f"call); peak {peak / 2**30:.2f} GiB; plain ops' words equal to the "
        f"CPU's on 4 rows; K3 on the decrypt's inputs {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.3f} ms, bound {k3_bound['bound_ms']:.4f} ms "
        f"({k3_bound['bound_by']}); bit-exact")
    return report, counts


def decode_prec(tlwe, torus, c, key, prec):
    """The message of a TLWE at precision prec, as an int mod 2^prec."""
    ph = tlwe.phase(c, key)
    return int(torus.torus2int(ph, prec)) % (1 << prec)


def ks_family_phase(p, key_trlwe, gk, gen, dev, max_clock):
    """Phase 22: the key-switch family on phase 4's ring key at TFHEpp-L2.
    (a) `priv_ks` as the TPU matrix runs it (`full_matrix_tpu.py:308-322`):
    a private KS pair (t=8, base_bit=4, three primes), one
    `priv_keyswitch_2` of a uniform message, exactly 2 K6 launches and no
    plain call, the phase within 2^50 of -s m.  (b) `tlwe_mul` as the matrix
    runs it (`:324-339`): 5 x 11 at precision 4 through a seeded packing1
    key (the TPU matrix's choice above 6 GiB; the streamed gather, no K2)
    and through the same key expanded (`expand_generic_ks_key`: one K2
    launch for both packing switches), each with one K6 relinearization at
    four primes (t=2, base_bit=20); the two give the same words and 7; the
    packing1 switch streamed and on the dense table, the same words (the
    check of `tests/test_keyswitch.py:240`) on STREAM_CHECK
    TLWEs, the streamed one timed.  (c) At B=512: K2 on
    the dense table's rows of 2N = 4096 words, K6 on the relinearization
    key (P=4) and on the pair's first key (P=3), each held bit-exact to its
    plain version on the path's inputs and timed beside its bound;
    `priv_keyswitch_2` of 512 TRLWEs (2 K6 launches, the plain route's
    words); `trgsw.ks_b_to_a` of one TRGSW(X^13) (2 K6 launches, exponent
    13, the plain route's words).  Keygen seconds and bytes of the seeded
    and the expanded table, warm ms of `tlwe_mul` (both keys),
    `priv_keyswitch_2` and the streamed apply, and the peak device memory.
    Returns the report, the paths' counts, the kernel runs and the keys the
    bootstrap family (phase 23) reuses: the dense packing1 table, the
    relinearization key and the pair."""
    from mosfhet_torch import keyswitch, polynomial, product, rng, tlwe, \
        torus, trgsw, trlwe
    from mosfhet_torch.ops import pbs_kernel as pk

    N, t, bb = p.N, p.t, p.base_bit
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    counts, runs, rep = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()

    def counted(path, fn, want):
        zero_counts(pk)
        out = fn()
        torch.cuda.synchronize()
        counts[path] = read_counts(pk)
        check_counts(path, counts[path], want)
        return out

    def plain_same(what, fn, got):
        with plain_kernels(pk):
            want = fn()
        torch.cuda.synchronize()
        w = want.rows if hasattr(want, "rows") else want.stacked()
        g = got.rows if hasattr(got, "rows") else got.stacked()
        same_or_fail(f"{what} vs its plain route", g, w)

    # (a) priv_ks
    pair = keyswitch.new_priv_ks_key_pair(key_trlwe, key_trlwe, t, bb, gen,
                                          dev)
    m = rng.uniform_torus(gen, (N,), dev)
    cc = trlwe.encrypt(m, key_trlwe, gen)
    out = counted("priv_ks", lambda: keyswitch.priv_keyswitch_2(cc, pair),
                  {"auto_keyswitch_stream": 2})
    want = -polynomial.ntt_mul_small(key_trlwe.s[0], m, key_trlwe.plan())
    e = signed_max_abs(trlwe.phase(out, key_trlwe) - want)
    if not e <= PRIV_KS_BOUND:
        fail(f"priv_ks: max error 2^{math.log2(e):.1f} > 2^50")
    rep["priv_ks"] = {
        "primes": len(pair[0].primes),
        "ms": cuda_ms(lambda: keyswitch.priv_keyswitch_2(cc, pair), REPS)[0],
        "decrypt_max_err_log2": math.log2(max(e, 1.0))}

    # (b) tlwe_mul, seeded then expanded
    rlk = keyswitch.new_rl_key(key_trlwe, RL_T, RL_BASE_BIT, gen, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seeded = keyswitch.new_packing1_ks_key_seeded(key_trlwe, key_out, t, bb,
                                                  gen, dev)
    torch.cuda.synchronize()
    seeded_s = time.perf_counter() - t0
    seeded_bytes = (seeded.seeds.numel() + seeded.b.numel()) * 8
    c1, c2 = (tlwe.encrypt(torus.int2torus(torch.tensor(v, device=dev),
                                           TLWE_MUL_PREC), key_out, gen)
              for v in TLWE_MUL_INPUTS)
    want_mul = TLWE_MUL_INPUTS[0] * TLWE_MUL_INPUTS[1] % (1 << TLWE_MUL_PREC)

    def mul(key):
        return product.tlwe_mul(c1, c2, TLWE_MUL_PREC, key, rlk)

    out_s = counted("tlwe_mul_streamed", lambda: mul(seeded),
                    {"auto_keyswitch_stream": 1})
    got_s = decode_prec(tlwe, torus, out_s, key_out, TLWE_MUL_PREC)
    mul_s_ms = cuda_ms(lambda: mul(seeded), REPS)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = keyswitch.expand_generic_ks_key(seeded)
    torch.cuda.synchronize()
    expand_s = time.perf_counter() - t0
    dense_bytes = dense.table.numel() * 8
    out_d = counted("tlwe_mul_dense", lambda: mul(dense),
                    {"tlwe_keyswitch_sum": 1, "auto_keyswitch_stream": 1})
    got_d = decode_prec(tlwe, torus, out_d, key_out, TLWE_MUL_PREC)
    if (got_s, got_d) != (want_mul, want_mul):
        fail(f"tlwe_mul: streamed {got_s}, K2 {got_d}, want {want_mul}")
    if not (torch.equal(out_s.a, out_d.a) and torch.equal(out_s.b, out_d.b)):
        fail("tlwe_mul: the streamed and the K2 route's words differ")
    mul_d_ms = cuda_ms(lambda: mul(dense), REPS)[0]
    # K2 on tlwe_mul's own two ciphertexts: below a tile of 128 it still
    # stages the whole table (PERF.md section 7)
    R, base_m1 = dense.table.shape[0], dense.table.shape[2]
    ab = dense.table.reshape(R, t, base_m1, -1)
    dig2 = keyswitch._gather_digits(torch.stack([c1.a, c2.a]), R, t, bb)
    k2_small, _ = k2_report(pk, "L2 tlwe_mul packing", dig2, ab, max_clock)
    rep["tlwe_mul"] = {
        "inputs": list(TLWE_MUL_INPUTS), "result": got_d,
        "streamed_ms": mul_s_ms, "dense_ms": mul_d_ms,
        "seeded_keygen_s": seeded_s, "seeded_bytes": seeded_bytes,
        "expand_s": expand_s, "dense_bytes": dense_bytes,
        "rl_primes": len(rlk.primes), "k2_ms": k2_small["ms"],
        "k2_bound": k2_small["bound"]}
    log(f"# L2 priv_ks: 2 K6 launches, max err "
        f"2^{rep['priv_ks']['decrypt_max_err_log2']:.1f} (bound 2^50), "
        f"{rep['priv_ks']['ms']:.3f} ms per call; tlwe_mul 5 x 11 = {got_d} "
        f"mod 16 by both routes, equal words: streamed {mul_s_ms:.3f} ms (1 "
        f"K6), dense {mul_d_ms:.3f} ms (1 K2 + 1 K6 at "
        f"{len(rlk.primes)} primes); seeded packing1 keygen {seeded_s:.3f} s,"
        f" {seeded_bytes / 2**30:.3f} GiB; expansion {expand_s:.3f} s, dense "
        f"table {dense_bytes / 2**30:.3f} GiB")

    # (c) the packing1 switch streamed and by K2 on the dense table, on
    # STREAM_CHECK TLWEs (the streamed gather is plain PyTorch: ~20 ms per
    # table row at B=512 on the card), then K2 at B=512
    cs = tlwe.encrypt(rng.uniform_torus(gen, (BATCH,), dev), key_out, gen)
    few = tlwe.TLWE(a=cs.a[:STREAM_CHECK], b=cs.b[:STREAM_CHECK])
    keyswitch.packing1_keyswitch(few, seeded)
    stream_ms, p_s = cuda_ms(lambda: keyswitch.packing1_keyswitch(few,
                                                                  seeded), 1)
    p_d = keyswitch.packing1_keyswitch(few, dense)
    if not (torch.equal(p_s.a, p_d.a) and torch.equal(p_s.b, p_d.b)):
        fail(f"packing1 on {STREAM_CHECK} TLWEs: streamed != K2 on the "
             f"expanded table")
    p_d = counted("packing1_batch",
                  lambda: keyswitch.packing1_keyswitch(cs, dense),
                  {"tlwe_keyswitch_sum": 1})
    dig = keyswitch._gather_digits(cs.a, R, t, bb)
    k2_run, sub_k = k2_report(pk, "L2 packing1", dig, ab, max_clock)
    k2_plain_ms, sub_p = cuda_ms(lambda: pk.tlwe_keyswitch_sum_plain(dig, ab),
                                 1)
    same_or_fail("K2 vs plain on packing1's inputs", sub_k, sub_p)
    runs["tlwe_keyswitch_sum"] = {
        "ms": k2_run["ms"], "plain_ms": k2_plain_ms, "max_abs_err": 0.0,
        "bound_ms": k2_run["bound"]["bound_ms"],
        "bound_by": k2_run["bound"]["bound_by"], "width": ab.shape[-1],
        "schedule": k2_run["schedule"]}
    rep["packing1_batch"] = {"streamed_ms": stream_ms,
                             "streamed_batch": STREAM_CHECK,
                             "k2_ms": k2_run["ms"],
                             "k2_bound": k2_run["bound"],
                             "k2_plain_ms": k2_plain_ms}
    del dig, ab, sub_k, sub_p, p_s, p_d
    # K6 at four primes on the relinearization key, 512 TRLWEs
    rs = np.random.default_rng(SEED + 22)
    x = random_u64(rs, (BATCH, p.k + 1, N), dev)
    kidx = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    ginv = torch.ones_like(kidx)
    for name, key in (("relinearization", rlk), ("priv_ks", pair[0])):
        kp = key.kernel_plan()
        ak = key.v32.reshape((1, -1) + tuple(key.v32.shape[2:]))
        pk.auto_keyswitch_stream_plain(x, ak, kidx, ginv, kp)   # warm
        hold(runs, f"auto_keyswitch_stream/{name}",
             lambda: pk.auto_keyswitch_stream(x, ak, kidx, ginv, kp),
             lambda: pk.auto_keyswitch_stream_plain(x, ak, kidx, ginv, kp),
             auto_ks_bound(kp, BATCH, kidx, max_clock), reps=KS_REPS)
        runs[f"auto_keyswitch_stream/{name}"]["primes"] = kp.P
    # priv_keyswitch_2 of 512 TRLWEs; ks_b_to_a of one TRGSW
    cb = trlwe.encrypt(rng.uniform_torus(gen, (BATCH, N), dev), key_trlwe,
                       gen)
    pb = counted("priv_ks_batch", lambda: keyswitch.priv_keyswitch_2(cb, pair),
                 {"auto_keyswitch_stream": 2})
    plain_same("priv_keyswitch_2 on 512 TRLWEs",
               lambda: keyswitch.priv_keyswitch_2(cb, pair), pb)
    rep["priv_ks_batch_ms"] = cuda_ms(
        lambda: keyswitch.priv_keyswitch_2(cb, pair), REPS)[0]
    g = trgsw.monomial_encrypt(1, KS_B_TO_A_EXP, gk, gen)
    gb = counted("ks_b_to_a", lambda: trgsw.ks_b_to_a(g, pair),
                 {"auto_keyswitch_stream": 2})
    if int(trgsw.debug_decrypt_exp(gb, gk)) != KS_B_TO_A_EXP:
        fail(f"ks_b_to_a: exponent {int(trgsw.debug_decrypt_exp(gb, gk))}, "
             f"want {KS_B_TO_A_EXP}")
    plain_same("ks_b_to_a", lambda: trgsw.ks_b_to_a(g, pair), gb)
    rep["ks_b_to_a_ms"] = cuda_ms(lambda: trgsw.ks_b_to_a(g, pair), REPS)[0]
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    r4, r3 = (runs[f"auto_keyswitch_stream/{n}"]
              for n in ("relinearization", "priv_ks"))
    log(f"# L2 key-switch family: packing1 streamed {stream_ms:.3f} ms on "
        f"{STREAM_CHECK} TLWEs (K2's words); at B={BATCH} K2 on the dense "
        f"table {k2_run['ms']:.4f} ms "
        f"(bound {k2_run['bound']['bound_ms']:.4f}, plain "
        f"{k2_plain_ms:.3f}); K6 P=4 (relinearization) {r4['ms']:.4f} ms "
        f"(bound {r4['bound_ms']:.4f}, plain {r4['plain_ms']:.3f}); K6 P=3 "
        f"(the pair) {r3['ms']:.4f} ms (bound {r3['bound_ms']:.4f}, plain "
        f"{r3['plain_ms']:.3f}); priv_keyswitch_2 "
        f"{rep['priv_ks_batch_ms']:.3f} ms (2 K6); ks_b_to_a exponent "
        f"{KS_B_TO_A_EXP}, {rep['ks_b_to_a_ms']:.3f} ms (2 K6); all "
        f"bit-exact to their plain versions; peak "
        f"{rep['peak_bytes'] / 2**30:.2f} GiB")
    del seeded, cs, x, cb, pb, g, gb
    torch.cuda.empty_cache()
    return rep, counts, runs, {"packing1": dense, "rlk": rlk, "pair": pair}


def ks_family32_phase(p, key_trlwe, gen, dev, max_clock):
    """Phase 22's L2_32 part, in the phase-20 child (t=6, base_bit=4,
    int32 words): the dense packing1 and private-SK tables (n and n+1
    rows, 3.02 GB each), packing1_keyswitch and priv_keyswitch of 512 TLWEs
    (1 K2 one-plane launch each, decrypt within 2^27), K2 held bit-exact to
    its plain version on each path's inputs and timed; priv_keyswitch_2 of
    512 TRLWEs (2 one-limb K6 launches, the plain route's words, decrypt
    within PRIV_KS_BOUND_32), K6 held and timed on its first launch's
    inputs.  Returns the report, the counts, the kernel runs and the two
    tables, which the bootstrap family's L2_32 part reuses."""
    from mosfhet_torch import keyswitch, polynomial, rng, tlwe, trlwe
    from mosfhet_torch.ops import pbs_kernel as pk

    N, t, bb = p.N, p.t, p.base_bit
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    counts, runs, rep, tables = {}, {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    m = rng.uniform_torus(gen, (BATCH,), dev)
    cs = tlwe.encrypt(m, key_out, gen)
    m_poly = torch.zeros((BATCH, N), dtype=m.dtype, device=dev)
    m_poly[:, 0] = m
    for path, new, fn, want in (
            ("packing1_batch", keyswitch.new_packing1_ks_key,
             keyswitch.packing1_keyswitch, lambda: m),
            ("priv_sk_batch", keyswitch.new_priv_sk_ks_key,
             keyswitch.priv_keyswitch,
             lambda: -polynomial.ntt_mul_small(key_trlwe.s[0], m_poly,
                                               key_trlwe.plan()))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ksk = new(key_trlwe, key_out, t, bb, gen, dev)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        zero_counts(pk)
        out = fn(cs, ksk)
        torch.cuda.synchronize()
        counts[path] = read_counts(pk)
        check_counts(f"L2_32 {path}", counts[path], {"tlwe_keyswitch_sum": 1})
        ph = trlwe.phase(out, key_trlwe)
        e = signed_max_abs(ph[:, 0] - want() if path == "packing1_batch"
                           else ph - want())
        if not e <= KS_DECRYPT_BOUND_32:
            fail(f"L2_32 {path}: max error 2^{math.log2(e):.1f} > 2^27")
        R, base_m1 = ksk.table.shape[0], ksk.table.shape[2]
        a_vals = cs.a if path == "packing1_batch" else torch.cat(
            [cs.a, cs.b[:, None]], dim=1)
        dig = keyswitch._gather_digits(a_vals, R, t, bb)
        ab = ksk.table.reshape(R, t, base_m1, -1)
        k2_run, sub_k = k2_report(pk, f"L2_32 {path}", dig, ab, max_clock)
        plain_ms, sub_p = cuda_ms(lambda: pk.tlwe_keyswitch_sum_plain(dig, ab),
                                  1)
        same_or_fail(f"K2/torus32 vs plain on {path}'s inputs", sub_k, sub_p)
        runs[f"tlwe_keyswitch_sum/{path}"] = {
            "ms": k2_run["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0,
            "bound_ms": k2_run["bound"]["bound_ms"],
            "bound_by": k2_run["bound"]["bound_by"], "width": ab.shape[-1],
            "rows": R, "schedule": k2_run["schedule"]}
        rep[path] = {"keygen_s": keygen_s,
                     "table_bytes": ksk.table.numel() * 4,
                     "decrypt_max_err_log2": math.log2(max(e, 1.0)),
                     "k2_ms": k2_run["ms"], "k2_plain_ms": plain_ms,
                     "k2_bound_ms": k2_run["bound"]["bound_ms"]}
        tables[path] = ksk
        del out, dig, ab, sub_k, sub_p
        torch.cuda.empty_cache()
    pair = keyswitch.new_priv_ks_key_pair(key_trlwe, key_trlwe, t, bb, gen,
                                          dev)
    mm = rng.uniform_torus(gen, (BATCH, N), dev)
    cb = trlwe.encrypt(mm, key_trlwe, gen)
    zero_counts(pk)
    pb = keyswitch.priv_keyswitch_2(cb, pair)
    torch.cuda.synchronize()
    counts["priv_ks_batch"] = read_counts(pk)
    check_counts("L2_32 priv_ks_batch", counts["priv_ks_batch"],
                 {"auto_keyswitch_stream": 2})
    with plain_kernels(pk):
        pw = keyswitch.priv_keyswitch_2(cb, pair)
    same_or_fail("L2_32 priv_keyswitch_2 vs its plain route", pb.stacked(),
                 pw.stacked())
    want = -polynomial.ntt_mul_small(key_trlwe.s[0], mm, key_trlwe.plan())
    e = signed_max_abs(trlwe.phase(pb, key_trlwe) - want)
    if not e <= PRIV_KS_BOUND_32:
        fail(f"L2_32 priv_ks: max error 2^{math.log2(e):.1f} > "
             f"2^{math.log2(PRIV_KS_BOUND_32):.0f}")
    kp = pair[0].kernel_plan()
    ak = pair[0].v32.reshape((1, -1) + tuple(pair[0].v32.shape[2:]))
    x = torch.cat([cb.a, torch.zeros_like(cb.b)[:, None]], dim=1)
    kidx = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    ginv = torch.ones_like(kidx)
    pk.auto_keyswitch_stream_plain(x, ak, kidx, ginv, kp)   # warm
    hold(runs, "auto_keyswitch_stream/priv_ks",
         lambda: pk.auto_keyswitch_stream(x, ak, kidx, ginv, kp),
         lambda: pk.auto_keyswitch_stream_plain(x, ak, kidx, ginv, kp),
         auto_ks_bound(kp, BATCH, kidx, max_clock), reps=KS_REPS)
    rep["priv_ks_batch"] = {
        "ms": cuda_ms(lambda: keyswitch.priv_keyswitch_2(cb, pair),
                      REPS)[0],
        "decrypt_max_err_log2": math.log2(max(e, 1.0)),
        "k6_ms": runs["auto_keyswitch_stream/priv_ks"]["ms"]}
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    r = runs["auto_keyswitch_stream/priv_ks"]
    log(f"# L2_32 key-switch family at B={BATCH}: packing1 K2 "
        f"{rep['packing1_batch']['k2_ms']:.4f} ms (plain "
        f"{rep['packing1_batch']['k2_plain_ms']:.3f}), priv-SK K2 "
        f"{rep['priv_sk_batch']['k2_ms']:.4f} ms, tables "
        f"{rep['packing1_batch']['table_bytes'] / 1e9:.2f} GB each (keygen "
        f"{rep['packing1_batch']['keygen_s']:.3f} / "
        f"{rep['priv_sk_batch']['keygen_s']:.3f} s); priv_keyswitch_2 "
        f"{rep['priv_ks_batch']['ms']:.3f} ms, K6 one-limb {r['ms']:.4f} ms "
        f"(bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.3f}); all "
        f"bit-exact; decrypt OK; peak {rep['peak_bytes'] / 2**30:.2f} GiB")
    del pair, cb, pb, pw, x, cs
    torch.cuda.empty_cache()
    return rep, counts, runs, tables


def head_words(out, n):
    """The word tensors of the first n ciphertexts of an output: a TLWE or
    TRLWE (a, b), a TRGSW (rows), or a list of them."""
    if isinstance(out, (list, tuple)):
        return [w for o in out for w in head_words(o, n)]
    if hasattr(out, "rows"):
        return [out.rows[:n]]
    return [out.a[:n], out.b[:n]]


def first_cts(c, n):
    from mosfhet_torch import tlwe
    return tlwe.TLWE(a=c.a[:n].contiguous(), b=c.b[:n].contiguous())


def err_log2(e):
    return math.log2(max(e, 1.0))


def run_family(pk, name, fn, c, want, counts, rep, plain_n=FAMILY_PLAIN):
    """``fn(c)`` for the batch ``c``: the counts zeroed just before and read
    just after must be exactly ``want``; then one warm call timed, and the
    whole call with the plain versions on the first ``plain_n`` ciphertexts
    (0: none), which must give the same words.  Returns the output."""
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(c)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts[name] = read_counts(pk)
    check_counts(name, counts[name], want)
    warm_ms, _ = cuda_ms(lambda: fn(c), FAMILY_REPS)
    r = {"first_call_s": first_s, "warm_ms": warm_ms,
         "batch": int(c.b.shape[0])}
    if plain_n:
        few = first_cts(c, plain_n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_kernels(pk):
            ref = fn(few)
        torch.cuda.synchronize()
        r["plain_first2_s"] = time.perf_counter() - t0
        for g, w in zip(head_words(out, plain_n), head_words(ref, plain_n)):
            same_or_fail(f"{name} on the first {plain_n} ciphertexts vs its "
                         f"plain route", g, w)
    rep[name] = r
    return out


def boot_family_phase(p, key_tlwe, key_trlwe, gk, bk, tv, luts, gen, dev,
                      max_clock, ks_keys):
    """Phase 23: the rest of `bootstrap` at TFHEpp-L2 on phase 4's keys,
    phase 22's dense packing1 table, relinearization key and private KS
    pair, and a dense private-SK table (t=8, base_bit=4) made here.
    (a) The four matrix ops of `benchmarks/full_matrix_tpu.py` as it runs
    them, one ciphertext each: trgsw_bootstrap (m = 2/8, torus base 4,
    within 2^59 of luts[2]), fdfb_ks21 (8 LUT values each repeated 2N/8
    times, m = 5, torus base 8, within 2^58), fdfb_clot21 (precision 4,
    m = 6, within 2^59), circuit_bootstrap v1 (m = 1/4, then
    `trgsw.external_product` of a TRLWE of a uniform message, within 2^59
    of it).  (b) B = 512 ciphertexts of every message through each function
    (`run_family`: the launch counts of PERF.md's table exactly, the
    decrypt bounds above, the warm ms, and the plain route on the first 2
    ciphertexts giving the same words), with public_mux on 512 selectors
    (no kernel, within 2^56) and phase 2 for one and for 4 LUTs (no
    kernel, within 2^58).  (c) K1 on the TRGSW bootstrap's 4,096 rows
    timed at full depth beside its bound and held bit-exact to its plain
    version over the first ROWS_CHECK_STEPS steps (the plain version takes
    about 2 s per step on 4,096 rows); K2 on CB v1's private-SK rows (n+1 =
    2,049 rows of 4,096 words) held and timed.  Frees the tables.  Returns
    the report, the counts and the kernel runs."""
    from mosfhet_torch import bootstrap, keyswitch, rng, tlwe, torus, \
        trgsw, trlwe
    from mosfhet_torch.ops import pbs_kernel as pk

    t_phase = time.perf_counter()
    N, k, l, bg = p.N, p.k, p.l, p.Bg_bit
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    p1, rlk, pair = ks_keys["packing1"], ks_keys["rlk"], ks_keys["pair"]
    counts, runs, rep = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kska = keyswitch.new_priv_sk_ks_key(key_trlwe, key_out, p.t, p.base_bit,
                                        gen, dev)
    torch.cuda.synchronize()
    rep["priv_sk_keygen_s"] = time.perf_counter() - t0
    rep["priv_sk_bytes"] = kska.table.numel() * 8
    rep["packing1_bytes"] = p1.table.numel() * 8

    def enc(m):
        return tlwe.encrypt(m, key_tlwe, gen)

    def err(ph, want):
        return signed_max_abs(ph - want)

    def bounded(what, e, bound):
        if not e <= bound:
            fail(f"{what}: max error 2^{err_log2(e):.1f} > "
                 f"2^{math.log2(bound):.0f}")
        return err_log2(e)

    def cb_err(g, ctrl, want):
        out = trgsw.external_product(ctrl, trgsw.to_dft(g, gk.plan()))
        return err(trlwe.phase(out, key_trlwe), want)

    # (a) the matrix ops, one ciphertext each
    matrix = {}
    cm = enc(torus.double2torus(torch.tensor(2 / 8.0)))
    g = bootstrap.functional_bootstrap_trgsw_phase1(cm, bk, 4, l, bg)
    out = bootstrap.functional_bootstrap_trgsw_phase2(g, tv)
    matrix["trgsw_bootstrap"] = bounded(
        "matrix trgsw_bootstrap", err(tlwe.phase(out, key_out), luts[2]),
        2.0**59)
    luts8 = rng.uniform_torus(gen, (8,), dev)
    tvp = torch.repeat_interleave(luts8, (2 * N) // 8)
    cm = enc(torus.int2torus(torch.tensor(5, device=dev), 3))
    out = bootstrap.fdfb_ks21(tvp, cm, bk, p1, KS21_TB)
    matrix["fdfb_ks21"] = bounded(
        "matrix fdfb_ks21", err(tlwe.phase(out, key_out), luts8[5]), 2.0**58)
    lutsq = torus.int2torus(rng.uniform_torus(gen, (8,), dev) & 15,
                            CLOT21_PREC)
    tv0 = trlwe.torus_packing(lutsq[:4], k, N)
    tv1 = trlwe.torus_packing(lutsq[4:], k, N)
    cm = enc(torus.int2torus(torch.tensor(6, device=dev), 3))
    out = bootstrap.fdfb_clot21(tv0, tv1, cm, bk, p1, rlk, CLOT21_PREC)
    matrix["fdfb_clot21"] = bounded(
        "matrix fdfb_clot21", err(tlwe.phase(out, key_out), lutsq[6]),
        2.0**59)
    m0 = rng.uniform_torus(gen, (N,), dev)
    ctrl = trlwe.encrypt(m0, key_trlwe, gen)
    cm = enc(torus.double2torus(torch.tensor(1 / 4.0)))
    g = bootstrap.circuit_bootstrap(cm, bk, kska, p1, l, bg)
    matrix["circuit_bootstrap"] = bounded("matrix circuit_bootstrap",
                                          cb_err(g, ctrl, m0), 2.0**59)
    log(f"# L2 matrix ops trgsw_bootstrap, fdfb_ks21, fdfb_clot21, "
        f"circuit_bootstrap pass: max err "
        + ", ".join(f"2^{v:.1f}" for v in matrix.values())
        + " (bounds 2^59, 2^58, 2^59, 2^59)")
    rep["matrix_err_log2"] = matrix

    # (b) B = 512 ciphertexts of every message through each function
    idx = torch.arange(BATCH, device=dev)
    m4, bits, m8 = idx % 4, idx % 2, idx % 8
    c4 = enc(torus.double2torus(m4.to(torch.float64) / 8.0))
    cbits = enc(torus.double2torus(bits.to(torch.float64) / 4.0))
    c8 = enc(torus.int2torus(m8, 3))
    errs = {}
    K1, K2, K3, K6 = ("blind_rotate_scan", "tlwe_keyswitch_sum",
                      "ext_product_apply_scan", "auto_keyswitch_stream")

    out = run_family(pk, "trgsw_bootstrap", lambda c: (
        bootstrap.functional_bootstrap_trgsw_phase2(
            bootstrap.functional_bootstrap_trgsw_phase1(c, bk, 4, l, bg),
            tv)), c4, {K1: 1, K3: 1}, counts, rep)
    errs["trgsw_bootstrap"] = bounded(
        "trgsw_bootstrap", err(tlwe.phase(out, key_out), luts[m4]), 2.0**59)
    want_cb = m0 * bits[:, None]
    for name, fn, ka, want, cb_bound in (
            ("circuit_bootstrap", bootstrap.circuit_bootstrap, kska,
             {K1: l, K2: 2 * l}, 2.0**59),
            ("circuit_bootstrap_2", bootstrap.circuit_bootstrap_2, kska,
             {K1: 1, K2: 2 * l}, 2.0**59),
            ("circuit_bootstrap_3", bootstrap.circuit_bootstrap_3, pair,
             {K1: 1, K2: l, K6: 2 * l}, CB3_BOUND)):
        g = run_family(pk, name, lambda c, fn=fn, ka=ka: fn(
            c, bk, ka, p1, l, bg), cbits, want, counts, rep)
        errs[name] = bounded(name, cb_err(g, ctrl, want_cb), cb_bound)
    for name, many, want in (("fdfb_ks21", True, {K1: 2, K2: l}),
                             ("fdfb_ks21_single", False, {K1: l + 1,
                                                          K2: l})):
        out = run_family(pk, name, lambda c, many=many: bootstrap.fdfb_ks21(
            tvp, c, bk, p1, KS21_TB, use_many_lut=many), c8, want, counts,
            rep)
        errs[name] = bounded(name, err(tlwe.phase(out, key_out), luts8[m8]),
                             2.0**58)
    for name, fn, want in (
            ("fdfb_clot21", lambda c: bootstrap.fdfb_clot21(
                tv0, tv1, c, bk, p1, rlk, CLOT21_PREC), {K1: 3, K2: 2,
                                                         K6: 2}),
            ("fdfb_clot21_2", lambda c: bootstrap.fdfb_clot21_2(
                lutsq, c, bk, p1, rlk, CLOT21_PREC), {K1: 1, K2: 2, K6: 2})):
        out = run_family(pk, name, fn, c8, want, counts, rep)
        errs[name] = bounded(name, err(tlwe.phase(out, key_out), lutsq[m8]),
                             2.0**59)
    tvm = trlwe.torus_packing_many_lut(luts8, 4, 2, k, N)
    outs = run_family(pk, "multivalue_CLOT21", lambda c: (
        bootstrap.multivalue_bootstrap_CLOT21(tvm, c, bk, 4, 2)), c4,
        {K1: 1}, counts, rep)
    errs["multivalue_CLOT21"] = bounded("multivalue_CLOT21", max(
        err(tlwe.phase(o, key_out), luts8[4 * j + m4])
        for j, o in enumerate(outs)), 2.0**58)
    rot = run_family(pk, "multivalue_phase1", lambda c: (
        bootstrap.multivalue_bootstrap_phase1(c, bk, 4)), c4, {K1: 1},
        counts, rep)
    lut_tables = [[1, 0, 3, 2], [3, 0, 2, 1], [1, 1, 2, 3], [0, 3, 3, 0]]
    zero_counts(pk)
    o1 = bootstrap.multivalue_bootstrap_phase2(lut_tables[0], rot, 4, 2)
    om = bootstrap.multivalue_bootstrap_phase2_many(lut_tables, rot, 4, 2)
    torch.cuda.synchronize()
    counts["multivalue_phase2"] = read_counts(pk)
    check_counts("multivalue_phase2", counts["multivalue_phase2"], {})
    rep["multivalue_phase2_ms"] = cuda_ms(
        lambda: bootstrap.multivalue_bootstrap_phase2(lut_tables[0], rot, 4,
                                                      2), FAMILY_REPS)[0]
    rep["multivalue_phase2_many_ms"] = cuda_ms(
        lambda: bootstrap.multivalue_bootstrap_phase2_many(lut_tables, rot,
                                                           4, 2),
        FAMILY_REPS)[0]
    e2 = err(tlwe.phase(o1, key_out), torus.double2torus(
        torch.tensor(lut_tables[0], device=dev)[m4] / 8.0))
    for i, lv in enumerate(lut_tables):
        want = torus.double2torus(torch.tensor(lv, device=dev)[m4] / 8.0)
        e2 = max(e2, err(tlwe.phase(tlwe.TLWE(a=om.a[i], b=om.b[i]),
                                    key_out), want))
    errs["multivalue_phase2"] = bounded("multivalue_phase2", e2, 2.0**58)
    # public_mux on 512 selectors TRLWE(bit h_i)
    plan = key_trlwe.plan()
    q0 = rng.uniform_torus(gen, (N,), dev)
    q1 = rng.uniform_torus(gen, (N,), dev)
    rows = []
    for i in range(l):
        m = torch.zeros((BATCH, N), dtype=torus.TORUS_DTYPE, device=dev)
        m[:, 0] = bits * torus.to_signed(1 << (64 - (i + 1) * bg))
        rows.append(trlwe.to_dft(trlwe.encrypt(m, key_trlwe, gen), plan).v)
    sel_v = torch.stack(rows, dim=-4)
    zero_counts(pk)
    out = bootstrap.public_mux(q0, q1, sel_v, l, bg, k, N, plan.primes)
    torch.cuda.synchronize()
    counts["public_mux"] = read_counts(pk)
    check_counts("public_mux", counts["public_mux"], {})
    rep["public_mux_ms"] = cuda_ms(lambda: bootstrap.public_mux(
        q0, q1, sel_v, l, bg, k, N, plan.primes), FAMILY_REPS)[0]
    errs["public_mux"] = bounded("public_mux", err(
        trlwe.phase(out, key_trlwe),
        torch.where(bits[:, None] == 1, q1, q0)), 2.0**56)
    del sel_v, rows, rot, outs, o1, om
    rep["decrypt_max_err_log2"] = errs

    # (c) K1 on the TRGSW bootstrap's rows, K2 on CB v1's private-SK rows
    log_N2 = int(math.log2(2 * N))
    b_int = torus.torus2int(c4.b + bootstrap._prec_offset(4), log_N2)
    tg = trgsw.mul_by_xai(trgsw.noiseless_trivial(1, l, bg, k, N, dev),
                          2 * N - b_int)
    R = tg.rows.shape[-3]
    acc0, a_int, _ = bootstrap.blind_rotate_inputs(
        trlwe.from_stacked(tg.rows), c4.a.unsqueeze(-2).expand(
            BATCH, R, c4.a.shape[-1]), bk)
    kp = bk.kernel_plan()
    key_bytes = (bk.v32.numel() + bk.vs32.numel()) * 4
    pk.blind_rotate_scan(acc0, a_int, bk.v32, bk.vs32, kp)
    k1_ms, _ = cuda_ms(lambda: pk.blind_rotate_scan(
        acc0, a_int, bk.v32, bk.vs32, kp), REPS)
    S = ROWS_CHECK_STEPS
    got = pk.blind_rotate_scan(acc0, a_int[:S], bk.v32[:S], bk.vs32[:S], kp)
    p_ms, want = cuda_ms(lambda: pk.blind_rotate_scan_plain(
        acc0, a_int[:S], bk.v32[:S], bk.vs32[:S], kp), 1)
    same_or_fail(f"K1 on the TRGSW rows' first {S} steps vs plain", got,
                 want)
    bound = rotation_bound_ms(kp, bk.n, acc0.shape[0], key_bytes, max_clock)
    runs["blind_rotate_scan/trgsw_rows"] = {
        "ms": k1_ms, "plain_ms": p_ms, "plain_steps": S, "max_abs_err": 0.0,
        "rows": int(acc0.shape[0]), "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"]}
    lut0 = torch.tensor([0, bootstrap._gadget_h(0, bg)],
                        dtype=torus.TORUS_DTYPE, device=dev)
    tmp = bootstrap.functional_bootstrap(trlwe.torus_packing(lut0, k, N),
                                         cbits, bk, 2)
    Rk, base_m1 = kska.table.shape[0], kska.table.shape[2]
    ab = kska.table.reshape(Rk, p.t, base_m1, -1)
    dig = keyswitch._gather_digits(torch.cat([tmp.a, tmp.b[:, None]], 1), Rk,
                                   p.t, p.base_bit)
    k2_run, sub_k = k2_report(pk, "L2 priv-SK (CB v1)", dig, ab, max_clock)
    k2_plain_ms, sub_p = cuda_ms(lambda: pk.tlwe_keyswitch_sum_plain(dig, ab),
                                 1)
    same_or_fail("K2 vs plain on CB v1's private-SK rows", sub_k, sub_p)
    runs["tlwe_keyswitch_sum/priv_sk"] = {
        "ms": k2_run["ms"], "plain_ms": k2_plain_ms, "max_abs_err": 0.0,
        "bound_ms": k2_run["bound"]["bound_ms"],
        "bound_by": k2_run["bound"]["bound_by"], "rows": Rk,
        "width": ab.shape[-1], "schedule": k2_run["schedule"]}
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    r1 = runs["blind_rotate_scan/trgsw_rows"]
    log(f"# L2 K1 on {r1['rows']} TRGSW rows: {k1_ms:.3f} ms (bound "
        f"{r1['bound_ms']:.3f}, {r1['bound_by']}); plain on the first {S} "
        f"steps {p_ms:.1f} ms, bit-exact; K2 on the private-SK table "
        f"({Rk} rows of {ab.shape[-1]} words) {k2_run['ms']:.4f} ms (bound "
        f"{k2_run['bound']['bound_ms']:.4f}, plain {k2_plain_ms:.2f}), "
        f"bit-exact")
    log("# L2 bootstrap family at B=512: " + "; ".join(
        f"{name} {r['warm_ms']:.1f} ms (plain route on 2: "
        f"{r.get('plain_first2_s', 0):.1f} s)" for name, r in rep.items()
        if isinstance(r, dict) and "warm_ms" in r)
        + f"; decrypt max err " + ", ".join(
            f"{n} 2^{v:.1f}" for n, v in errs.items())
        + f"; private-SK keygen {rep['priv_sk_keygen_s']:.2f} s, "
          f"{rep['priv_sk_bytes'] / 1e9:.2f} GB; peak "
          f"{rep['peak_bytes'] / 2**30:.2f} GiB")
    del kska, acc0, a_int, got, want, dig, ab, sub_k, sub_p, tg
    ks_keys.clear()
    torch.cuda.empty_cache()
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 23 (bootstrap family): {rep['seconds']:.1f} s")
    return rep, counts, runs


def boot_family32_phase(p, key_tlwe, key_trlwe, gk, bk, luts, gen, dev,
                        max_clock, tables):
    """Phase 23's L2_32 part, in the phase-20 child (l=3, Bg_bit=7, N=2048;
    the packing1 and private-SK tables of phase 22's L2_32 part, t=6,
    base_bit=4), B = 512 ciphertexts of every message: the TRGSW bootstrap
    (1 K1 + 1 K3), the circuit bootstrap v1 (3 K1 + 6 K2), fdfb_ks21 with a
    bootstrap per level (4 K1 + 3 K2), multi-value CLOT21 and phase 1 (1
    K1 each), phase 2 and public_mux (no kernel), each through the
    one-limb kernels with the launch counts exact; multi-value CLOT21
    within 2^26 (the PBS's bound: the same rotation), phase 2 within 2^28
    (half the 2^29 spacing of its digit values) and public_mux within 2^28
    (the TPU suite's).  The TRGSW bootstrap, CB v1 and fdfb_ks21 carry a
    rotated ciphertext's noise (sigma ~2^23.7 at L2_32) times gadget digits
    up to 2^6 over (k+1)l N terms (~2^12) into their outputs, past what
    the 32-bit torus holds (in the TPU package too: the same words): their
    errors are reported, not bounded.  CB v2/v3 and fdfb_ks21's many-LUT
    form need 2l and l torus_base / 2 to divide N, which l = 3 does not;
    fdfb_clot21 and _2 raise NotImplementedError (64-bit only), checked
    here before any launch.  One-limb K1 on the TRGSW bootstrap's 4,096
    rows (timed at full depth, held over the first ROWS_CHECK_STEPS
    steps) and one-limb K2 on CB v1's private-SK rows, held and timed.
    Frees the tables.  Returns the report, the counts and the kernel
    runs."""
    from mosfhet_torch import bootstrap, keyswitch, rng, tlwe, torus, \
        trgsw, trlwe
    from mosfhet_torch.ops import pbs_kernel as pk

    t_phase = time.perf_counter()
    N, k, l, bg = p.N, p.k, p.l, p.Bg_bit
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    p1, kska = tables["packing1_batch"], tables["priv_sk_batch"]
    counts, runs, rep, errs = {}, {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    K1, K2, K3 = ("blind_rotate_scan", "tlwe_keyswitch_sum",
                  "ext_product_apply_scan")

    def err(ph, want):
        return signed_max_abs(ph - want)

    def bounded(what, e, bound):
        if not e <= bound:
            fail(f"L2_32 {what}: max error 2^{err_log2(e):.1f} > "
                 f"2^{math.log2(bound):.0f}")
        return err_log2(e)

    idx = torch.arange(BATCH, device=dev)
    m4, bits, m8 = idx % 4, idx % 2, idx % 8
    c4 = tlwe.encrypt(torus.double2torus(m4.to(torch.float64) / 8.0),
                      key_tlwe, gen)
    cbits = tlwe.encrypt(torus.double2torus(bits.to(torch.float64) / 4.0),
                         key_tlwe, gen)
    c8 = tlwe.encrypt(torus.int2torus(m8, 3), key_tlwe, gen)
    tv = trlwe.torus_packing(luts, k, N)
    out = run_family(pk, "trgsw_bootstrap", lambda c: (
        bootstrap.functional_bootstrap_trgsw_phase2(
            bootstrap.functional_bootstrap_trgsw_phase1(c, bk, 4, l, bg),
            tv)), c4, {K1: 1, K3: 1}, counts, rep, 0)
    errs["trgsw_bootstrap"] = err_log2(err(tlwe.phase(out, key_out),
                                           luts[m4]))
    m0 = rng.uniform_torus(gen, (N,), dev)
    ctrl = trlwe.encrypt(m0, key_trlwe, gen)
    g = run_family(pk, "circuit_bootstrap", lambda c: (
        bootstrap.circuit_bootstrap(c, bk, kska, p1, l, bg)), cbits,
        {K1: l, K2: 2 * l}, counts, rep, 0)
    out = trgsw.external_product(ctrl, trgsw.to_dft(g, gk.plan()))
    errs["circuit_bootstrap"] = err_log2(err(trlwe.phase(out, key_trlwe),
                                             m0 * bits[:, None]))
    luts8 = rng.uniform_torus(gen, (8,), dev)
    tvp = torch.repeat_interleave(luts8, (2 * N) // 8)
    out = run_family(pk, "fdfb_ks21_single", lambda c: bootstrap.fdfb_ks21(
        tvp, c, bk, p1, KS21_TB, use_many_lut=False), c8,
        {K1: l + 1, K2: l}, counts, rep, 0)
    errs["fdfb_ks21_single"] = err_log2(err(tlwe.phase(out, key_out),
                                            luts8[m8]))
    tvm = trlwe.torus_packing_many_lut(luts8, 4, 2, k, N)
    outs = run_family(pk, "multivalue_CLOT21", lambda c: (
        bootstrap.multivalue_bootstrap_CLOT21(tvm, c, bk, 4, 2)), c4,
        {K1: 1}, counts, rep, 0)
    errs["multivalue_CLOT21"] = bounded("multivalue_CLOT21", max(
        err(tlwe.phase(o, key_out), luts8[4 * j + m4])
        for j, o in enumerate(outs)), DECRYPT_BOUND_32)
    rot = run_family(pk, "multivalue_phase1", lambda c: (
        bootstrap.multivalue_bootstrap_phase1(c, bk, 4)), c4, {K1: 1},
        counts, rep, 0)
    lv = [1, 0, 3, 2]
    zero_counts(pk)
    o2 = bootstrap.multivalue_bootstrap_phase2(lv, rot, 4, 2)
    torch.cuda.synchronize()
    counts["multivalue_phase2"] = read_counts(pk)
    check_counts("L2_32 multivalue_phase2", counts["multivalue_phase2"], {})
    errs["multivalue_phase2"] = bounded("multivalue_phase2", err(
        tlwe.phase(o2, key_out), torus.double2torus(
            torch.tensor(lv, device=dev)[m4] / 8.0)), 2.0**28)
    plan = key_trlwe.plan()
    q0 = rng.uniform_torus(gen, (N,), dev)
    q1 = rng.uniform_torus(gen, (N,), dev)
    rows = []
    for i in range(l):
        m = torch.zeros((BATCH, N), dtype=torus.TORUS_DTYPE, device=dev)
        m[:, 0] = (bits * (1 << (32 - (i + 1) * bg))).to(torus.TORUS_DTYPE)
        rows.append(trlwe.to_dft(trlwe.encrypt(m, key_trlwe, gen), plan).v)
    zero_counts(pk)
    out = bootstrap.public_mux(q0, q1, torch.stack(rows, dim=-4), l, bg, k,
                               N, plan.primes)
    torch.cuda.synchronize()
    counts["public_mux"] = read_counts(pk)
    check_counts("L2_32 public_mux", counts["public_mux"], {})
    errs["public_mux"] = bounded("public_mux", err(
        trlwe.phase(out, key_trlwe), torch.where(bits[:, None] == 1, q1, q0)),
        2.0**28)
    for name in ("fdfb_clot21", "fdfb_clot21_2"):
        zero_counts(pk)
        try:
            getattr(bootstrap, name)(*([None] * (7 if name[-1] == "1"
                                                 else 6)))
            fail(f"L2_32 {name} did not raise NotImplementedError")
        except NotImplementedError:
            pass
        check_counts(f"L2_32 {name}", read_counts(pk), {})
    del rows, rot, outs, o2
    rep["decrypt_max_err_log2"] = errs
    # one-limb K1 on the TRGSW rows, one-limb K2 on CB v1's private-SK rows
    log_N2 = int(math.log2(2 * N))
    b_int = torus.torus2int(c4.b + bootstrap._prec_offset(4), log_N2)
    tg = trgsw.mul_by_xai(trgsw.noiseless_trivial(1, l, bg, k, N, dev),
                          2 * N - b_int)
    R = tg.rows.shape[-3]
    acc0, a_int, _ = bootstrap.blind_rotate_inputs(
        trlwe.from_stacked(tg.rows), c4.a.unsqueeze(-2).expand(
            BATCH, R, c4.a.shape[-1]), bk)
    kp = bk.kernel_plan()
    pk.blind_rotate_scan(acc0, a_int, bk.v32, bk.vs32, kp)
    k1_ms, _ = cuda_ms(lambda: pk.blind_rotate_scan(
        acc0, a_int, bk.v32, bk.vs32, kp), REPS)
    S = ROWS_CHECK_STEPS
    got = pk.blind_rotate_scan(acc0, a_int[:S], bk.v32[:S], bk.vs32[:S], kp)
    p_ms, want = cuda_ms(lambda: pk.blind_rotate_scan_plain(
        acc0, a_int[:S], bk.v32[:S], bk.vs32[:S], kp), 1)
    same_or_fail(f"one-limb K1 on the TRGSW rows' first {S} steps vs plain",
                 got, want)
    bound = rotation_bound_ms(kp, bk.n, acc0.shape[0],
                              (bk.v32.numel() + bk.vs32.numel()) * 4,
                              max_clock)
    runs["blind_rotate_scan/trgsw_rows"] = {
        "ms": k1_ms, "plain_ms": p_ms, "plain_steps": S, "max_abs_err": 0.0,
        "rows": int(acc0.shape[0]), "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"]}
    lut0 = torch.tensor([0, bootstrap._gadget_h(0, bg)],
                        dtype=torus.TORUS_DTYPE, device=dev)
    tmp = bootstrap.functional_bootstrap(trlwe.torus_packing(lut0, k, N),
                                         cbits, bk, 2)
    Rk, base_m1 = kska.table.shape[0], kska.table.shape[2]
    ab = kska.table.reshape(Rk, p.t, base_m1, -1)
    dig = keyswitch._gather_digits(torch.cat([tmp.a, tmp.b[:, None]], 1), Rk,
                                   p.t, p.base_bit)
    k2_run, sub_k = k2_report(pk, "L2_32 priv-SK (CB v1)", dig, ab,
                              max_clock)
    k2_plain_ms, sub_p = cuda_ms(lambda: pk.tlwe_keyswitch_sum_plain(dig, ab),
                                 1)
    same_or_fail("one-plane K2 vs plain on CB v1's private-SK rows", sub_k,
                 sub_p)
    runs["tlwe_keyswitch_sum/priv_sk"] = {
        "ms": k2_run["ms"], "plain_ms": k2_plain_ms, "max_abs_err": 0.0,
        "bound_ms": k2_run["bound"]["bound_ms"],
        "bound_by": k2_run["bound"]["bound_by"], "rows": Rk,
        "width": ab.shape[-1], "schedule": k2_run["schedule"]}
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"# L2_32 bootstrap family at B={BATCH}: " + "; ".join(
        f"{name} {r['warm_ms']:.1f} ms" for name, r in rep.items()
        if isinstance(r, dict) and "warm_ms" in r)
        + "; decrypt max err " + ", ".join(
            f"{n} 2^{v:.1f}" for n, v in errs.items())
        + f"; one-limb K1 on {acc0.shape[0]} rows {k1_ms:.3f} ms (bound "
          f"{bound['bound_ms']:.3f}), K2 on the private-SK rows "
          f"{k2_run['ms']:.4f} ms, both bit-exact; "
          f"{rep['seconds']:.1f} s")
    del acc0, a_int, got, want, dig, ab, sub_k, sub_p, tg
    tables.clear()
    torch.cuda.empty_cache()
    return rep, counts, runs


def etl_launches(S, tb):
    """(K1, K2) launches of `ufhe.encrypted_tlwe_lut` on S entries: per
    level one key switch of the selector's digit, then per group of tb
    entries one LUT packing switch and one bootstrap."""
    k1 = k2 = 0
    while S > 1:
        k1 += S // tb
        k2 += 1 + S // tb
        S //= tb
    return k1, k2


def ufhe_launches(op, d, out_d, tb):
    """(K1, K2) launches of the ufhe op on unsigned integers of d digits
    (relu: signed), derived from `mosfhet_torch/apps/ufhe.py`: every carry
    bootstrap is 1 K2 (the key switch back to the LWE key) + 1 K1, a
    multi-value phase 1 is 1 K1, a LUT packing switch 1 K2."""
    if op == "add":                       # sl_add_integer, g = h = 0
        n = min(d + 1, out_d)
        return n, n
    if op == "sub":
        return out_d, out_d
    if op == "cmp":                       # switch, packing, bootstrap per digit
        return d, 2 * d
    if op == "relu":                      # one switch; d - 1 packings; d boots
        return d, d
    if op == "mul":
        size = min(2 * d + 1, out_d)
        k1 = k2 = 0
        for i in range(d):
            js = min(d, max(0, size - i))
            carries = max(0, min(d + 1 + i + 1, out_d) - i)
            k1 += 1 + 2 * js + d + carries      # phase 1, two LUTs per digit
            k2 += 1 + 2 + js + d + carries      # switch, two packings, ...
        return k1, k2
    if op == "lut":                       # phase 1, then a tree per digit
        e1, e2 = etl_launches(tb ** d // tb, tb)
        return 1 + out_d * e1, 1 + out_d * e2
    if op == "mux":                       # a tree over tb entries per digit
        e1, e2 = etl_launches(tb, tb)
        return out_d * e1, out_d * e2
    raise ValueError(op)


def apps_phase(p_l2, gk_l2, key_trlwe_l2, gen, dev, max_clock):
    """Phase 24: the applications.  ufhe at UFHE_SET0 (n=630, N=2048, l=6,
    Bg_bit=7, t=6, base_bit=2, torus base 4): the port's keygens (seconds,
    bytes; the LUT packing table 2,048 x 4 x 6 x 3 rows of 4,096 words),
    then UFHE_BATCH pairs of UFHE_PREC-bit integers (3 digits; the defaults
    of `benchmarks/bench_ufhe_batch.py`) through add (4 digits), sub (3),
    mul (6), cmp, relu (signed), lut_integer (a 64-entry LUT, 3 digits) and
    mux_integer_array (a 1-digit selector over 4 integers, 3 digits): every
    element decrypts to its cleartext result; counts zeroed just before
    each op and read just after equal `ufhe_launches` exactly; warm ms per
    op.  K1 at l=6 (J = 12 rows) held bit-exact to its plain version on
    add's first carry bootstrap (64 ciphertexts, full depth) and timed
    beside its bound; K2 at base_bit=2 on add's first key switch (2,048
    rows of 631 words) and on mux's first LUT packing switch (the 4
    integers' digit 0: 8,192 rows of 4,096 words), each held and timed.  Then `apps.leveled_lut` at
    TFHEpp-L2 on phase 4's TRGSW key: `eval_lut` of m = 1234 over an
    N-entry LUT (1 K3 launch, within 2^57 of its value) and
    `eval_lut_vertical` of m = 5000 over a 4N-entry LUT (2 K3 launches for
    the CMUX tree, 1 K1 launch of log2 N steps; within 2^58).  Returns the
    report, the counts, the kernel runs and the ufhe keyset, context and
    add's integer pair, which phase 25 saves and loads."""
    from mosfhet_torch import bootstrap, params, tlwe, torus, trlwe
    from mosfhet_torch.apps import leveled_lut, ufhe
    from mosfhet_torch.ops import pbs_kernel as pk

    t_phase = time.perf_counter()
    p = params.UFHE_SET0
    counts, runs, rep = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    priv = ufhe.new_priv_keyset(gen, p, dev)
    pub = ufhe.new_public_keyset(gen, priv, torus_base=4, device=dev)
    ctx = ufhe.setup_context(pub)
    torch.cuda.synchronize()
    rep["keygen_s"] = time.perf_counter() - t0
    bk = pub.bootstrap_key
    rep["key_bytes"] = {
        "bootstrap": (bk.v32.numel() + bk.vs32.numel()) * 4,
        "ks": pub.ks_key.ab.numel() * 8,
        "lut_packing": pub.packing_key.table.numel() * 8}
    rep["keygen_peak_bytes"] = torch.cuda.max_memory_allocated()
    tb, lt = ctx.torus_base, ctx.log_torus_base
    d = ufhe._n_digits(UFHE_PREC, ctx)
    rs = np.random.default_rng(SEED + 25)
    va = rs.integers(0, 1 << UFHE_PREC, UFHE_BATCH)
    vb = rs.integers(0, 1 << UFHE_PREC, UFHE_BATCH)
    vs_ = rs.integers(-(1 << (UFHE_PREC - 1)), 1 << (UFHE_PREC - 1),
                      UFHE_BATCH)
    vsel = rs.integers(0, tb, UFHE_BATCH)
    lut = [int(x) for x in rs.integers(0, 1 << UFHE_PREC, 1 << UFHE_PREC)]

    def enc(vals, digits, signed):
        v = torch.from_numpy(np.asarray(vals) % (1 << (lt * digits))).to(dev)
        digs = torch.stack([(v >> (i * lt)) & (tb - 1)
                            for i in range(digits)])
        c = tlwe.encrypt(ufhe._digit_torus(digs, ctx), priv.extracted, gen)
        return ufhe.Integer(digits=c, signed=signed)

    def dec(c):
        ph = tlwe.phase(c.digits, priv.extracted)
        vals = (torch.round(torus.torus2double(ph) * (2 * tb))
                .to(torch.int64) % tb).cpu().numpy()
        out = np.zeros(vals.shape[1], np.int64)
        for i in range(vals.shape[0] - 1, -1, -1):
            out = (out << lt) | vals[i]
        if c.signed:
            bits = lt * c.d
            out = np.where(out >= 1 << (bits - 1), out - (1 << bits), out)
        return out

    a, b = enc(va, d, False), enc(vb, d, False)
    sa = enc(vs_, d, True)
    sel = enc(vsel, 1, False)
    vec = [enc(rs.integers(0, 1 << UFHE_PREC, UFHE_BATCH), d, False)
           for _ in range(tb)]
    vec_vals = [dec(v) for v in vec]
    ops = {
        "add": (lambda: ufhe.add_integer(a, b, d + 1, ctx), d + 1,
                (va + vb) % (1 << (lt * (d + 1)))),
        "sub": (lambda: ufhe.sub_integer(a, b, d, ctx), d,
                (va - vb) % (1 << UFHE_PREC)),
        "mul": (lambda: ufhe.mul_integer(a, b, 2 * d, ctx), 2 * d,
                (va * vb) % (1 << (2 * UFHE_PREC))),
        "cmp": (lambda: ufhe.cmp_integer(a, b, ctx), 1,
                np.where(va > vb, 2, np.where(va == vb, 1, 0))),
        "relu": (lambda: ufhe.relu_integer(sa, ctx), d, np.maximum(vs_, 0)),
        "lut": (lambda: ufhe.lut_integer(a, lut, 1 << UFHE_PREC, d, ctx), d,
                np.asarray(lut)[va]),
        "mux": (lambda: ufhe.mux_integer_array(sel, vec, d, ctx), d,
                np.stack(vec_vals)[vsel, np.arange(UFHE_BATCH)])}
    for name, (fn, out_d, want) in ops.items():
        k1, k2 = ufhe_launches(name, d, out_d, tb)
        zero_counts(pk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts[f"ufhe_{name}"] = read_counts(pk)
        check_counts(f"ufhe {name}", counts[f"ufhe_{name}"],
                     {"blind_rotate_scan": k1, "tlwe_keyswitch_sum": k2})
        got = dec(out)
        if not np.array_equal(got, want):
            bad = int((got != want).sum())
            fail(f"ufhe {name}: {bad} of {UFHE_BATCH} integers decrypt "
                 f"wrong")
        warm_ms, _ = cuda_ms(fn, FAMILY_REPS)
        rep[name] = {"first_call_s": first_s, "warm_ms": warm_ms,
                     "ms_per_integer_op": warm_ms / UFHE_BATCH,
                     "launches": {"K1": k1, "K2": k2},
                     "output_digits": out_d}
    # K1 at l=6 on add's first carry bootstrap; K2 at base_bit=2
    d0 = tlwe.add(ufhe._digit(a, 0), ufhe._digit(b, 0))
    sw = tlwe.keyswitch(d0, pub.ks_key)
    acc = bootstrap.rotate_test_vector(ctx.addsub_lut, sw, bk, tb)
    acc0, a_int, _ = bootstrap.blind_rotate_inputs(acc, sw.a, bk)
    kp = bk.kernel_plan()
    bound = rotation_bound_ms(kp, bk.n, acc0.shape[0],
                              (bk.v32.numel() + bk.vs32.numel()) * 4,
                              max_clock)
    pk.blind_rotate_scan(acc0, a_int, bk.v32, bk.vs32, kp)
    hold(runs, "blind_rotate_scan/ufhe_set0",
         lambda: pk.blind_rotate_scan(acc0, a_int, bk.v32, bk.vs32, kp),
         lambda: pk.blind_rotate_scan_plain(acc0, a_int, bk.v32, bk.vs32,
                                            kp), bound)
    runs["blind_rotate_scan/ufhe_set0"].update(
        {"J": kp.J, "batch": int(acc0.shape[0])})
    dig_ks = tlwe.keyswitch_inputs(d0, pub.ks_key)
    lut_in = ufhe._stack_tlwe([ufhe._digit(v, 0) for v in vec])
    tab = pub.packing_key.table
    R = tab.shape[0] * tab.shape[1]
    from mosfhet_torch import keyswitch
    a_vals = lut_in.a.transpose(-1, -2).reshape(UFHE_BATCH, -1)
    dig_lp = keyswitch._gather_digits(a_vals, R, p.t, p.base_bit)
    for tag, dig, ab in (
            ("ks", dig_ks, pub.ks_key.ab),
            ("lut_packing", dig_lp, tab.reshape(R, p.t, tab.shape[3], -1))):
        k2_run, sub_k = k2_report(pk, f"UFHE_SET0 {tag}", dig, ab, max_clock)
        plain_ms, sub_p = cuda_ms(lambda: pk.tlwe_keyswitch_sum_plain(dig, ab),
                                  1)
        same_or_fail(f"K2 vs plain on ufhe's {tag} digits", sub_k, sub_p)
        runs[f"tlwe_keyswitch_sum/ufhe_{tag}"] = {
            "ms": k2_run["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0,
            "bound_ms": k2_run["bound"]["bound_ms"],
            "bound_by": k2_run["bound"]["bound_by"], "rows": ab.shape[0],
            "values_per_digit": ab.shape[2], "width": ab.shape[-1],
            "schedule": k2_run["schedule"]}
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    r1 = runs["blind_rotate_scan/ufhe_set0"]
    log(f"# UFHE_SET0 keygen {rep['keygen_s']:.2f} s, "
        + ", ".join(f"{n} {v / 1e9:.3f} GB" for n, v in
                    rep["key_bytes"].items())
        + f"; at B={UFHE_BATCH}, {UFHE_PREC}-bit integers ({d} digits): "
        + "; ".join(f"{n} {rep[n]['warm_ms']:.1f} ms ({rep[n]['launches']['K1']}"
                    f" K1, {rep[n]['launches']['K2']} K2)" for n in ops)
        + f"; every integer decrypts right; K1 at l=6 {r1['ms']:.3f} ms "
          f"(bound {r1['bound_ms']:.3f}, plain {r1['plain_ms']:.1f}), "
          f"bit-exact; peak {rep['peak_bytes'] / 2**30:.2f} GiB")
    # phase 25 saves and loads this keyset, context and these integers
    keep = {"priv": priv, "ctx": ctx, "ints": [a, b]}
    del pub, bk, acc0, a_int, dig_ks, dig_lp, tab, a_vals, sa, sel, vec
    torch.cuda.empty_cache()

    # leveled LUT at TFHEpp-L2
    N = p_l2.N
    key_out = trlwe.extract_tlwe_key(key_trlwe_l2)
    values = torch.arange(N, device=dev) * 7 % 128
    enc_lut = leveled_lut.encrypt_lut(values, 7, key_trlwe_l2, gen)
    m_lut = 1234 % N
    enc_in = leveled_lut.encrypt_input(m_lut, gk_l2, gen)
    zero_counts(pk)
    out = leveled_lut.eval_lut(enc_in, enc_lut)
    torch.cuda.synchronize()
    counts["leveled_lut"] = read_counts(pk)
    check_counts("leveled_lut", counts["leveled_lut"],
                 {"ext_product_apply_scan": 1})
    e = signed_max_abs(tlwe.phase(out, key_out)
                       - torus.int2torus(values[m_lut], 7))
    if not e <= 2.0**57:
        fail(f"leveled_lut: max error 2^{err_log2(e):.1f} > 2^57")
    rep["leveled_lut"] = {"ms": cuda_ms(lambda: leveled_lut.eval_lut(
        enc_in, enc_lut), REPS)[0], "decrypt_max_err_log2": err_log2(e)}
    size = p_l2.log_N + 2
    table = torch.from_numpy(rs.integers(0, 16, 1 << size)).to(dev)
    luts = trlwe.encrypt(torus.int2torus(table, 4).reshape(-1, N),
                         key_trlwe_l2, gen)
    m_vert = 5000 % (1 << size)
    bits = leveled_lut.encrypt_input_bits(m_vert, size, gk_l2, gen)
    zero_counts(pk)
    out = leveled_lut.eval_lut_vertical(bits, size, luts)
    torch.cuda.synchronize()
    counts["vertical_packing"] = read_counts(pk)
    check_counts("vertical_packing", counts["vertical_packing"],
                 {"ext_product_apply_scan": 2, "blind_rotate_scan": 1})
    e = signed_max_abs(tlwe.phase(out, key_out)
                       - torus.int2torus(table[m_vert], 4))
    if not e <= 2.0**58:
        fail(f"vertical packing: max error 2^{err_log2(e):.1f} > 2^58")
    rep["vertical_packing"] = {
        "entries": 1 << size, "ms": cuda_ms(lambda: (
            leveled_lut.eval_lut_vertical(bits, size, luts)), REPS)[0],
        "decrypt_max_err_log2": err_log2(e)}
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"# leveled LUT at L2: eval_lut {rep['leveled_lut']['ms']:.3f} ms "
        f"(1 K3, err 2^{rep['leveled_lut']['decrypt_max_err_log2']:.1f}), "
        f"eval_lut_vertical over {1 << size} entries "
        f"{rep['vertical_packing']['ms']:.3f} ms (2 K3 + 1 K1, err "
        f"2^{rep['vertical_packing']['decrypt_max_err_log2']:.1f}); "
        f"phase 24 (apps): {rep['seconds']:.1f} s")
    return rep, counts, runs, keep


def torus_dist(x, y):
    """|x - y| on the 64-bit torus, for Python ints."""
    d = (int(x) - int(y)) % (1 << 64)
    return min(d, (1 << 64) - d)


def io_phase(p, key_tlwe, key_trlwe, gk, bk, ksk, tv, cs, luts, slots,
             ksk_r, key_in, ufhe_keep, gen, dev, max_clock):
    """Phase 25: keysets through `io` onto the card.  (a) The L2 gate
    keyset (phase 4's u=1 bootstrap key, phase 7's TLWE key-switch key)
    saved in the versioned container and loaded: 512 gates (1 K1, 1 K2)
    give the in-memory keyset's words.  (b) The reference's layouts at L2:
    a u=4 key (made here as phase 10 makes its own) in `save_bootstrap_key`'s
    time-domain layout, back bit for bit, one PBS of 512 (1 K4) with equal
    words; phase 4's key in the FFNT and SPQLIOS f64 DFT layouts, 512 PBS
    (1 K1 each) within 2^58; phase 15's TRLWE key-switch key in both DFT
    layouts, one `trlwe_keyswitch` of 512 (1 K6 each) within phase 15's
    bound.  (c) The reference's own files (tests/vectors/) imported onto
    the card: the u=2 key (K4) within 2^36 of the reference's output phase,
    the u=1 DFT keys (K1), the TRLWE key-switch keys (K6), the packing and
    packing1 keys with their masks expanded by `native` (K2), the vaes
    sample, and the replayed stream and its DFT-stored key (K1); every path
    also run whole on the plain versions, word for word.  (d) ufhe at
    UFHE_SET0: phase 24's keyset, context and 64-integer pairs saved and
    loaded, one `add_integer` with the loaded context giving the in-memory
    words.  Prints bytes, seconds, peak memory and each decrypt error.
    Returns the report, the counts and the paths held per kernel."""
    from mosfhet_torch import bootstrap, io, keyswitch, ntt, rng, tlwe
    from mosfhet_torch import torus, trlwe
    from mosfhet_torch.apps import ufhe
    from mosfhet_torch.ops import pbs_kernel as pk
    from mosfhet_torch.refrng import RefStream

    t_phase = time.perf_counter()
    rep, counts, held = {}, {}, {}
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    rep["disk_free_bytes"] = shutil.disk_usage(tmp).free
    log(f"# phase 25 (io): {rep['disk_free_bytes'] / 1e9:.1f} GB free "
        f"under {os.path.dirname(tmp)}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def write(name, fn):
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            fn(f)
        return path

    def read(path, fn, *args, **kw):
        with open(path, "rb") as f:
            return fn(f, *args, **kw)

    def vec(name, fn, *args, **kw):
        return read(os.path.join(VECTORS, name), fn, *args, **kw)

    def on_path(name, fn, want):
        """fn() with the counts zeroed just before and read just after, then
        whole on the plain versions: the same words."""
        zero_counts(pk)
        out = fn()
        torch.cuda.synchronize()
        counts[name] = read_counts(pk)
        check_counts(name, counts[name], want)
        with plain_kernels(pk):
            ref = fn()
        same_or_fail(f"{name} vs its plain route (a)", out.a, ref.a)
        same_or_fail(f"{name} vs its plain route (b)", out.b, ref.b)
        for kernel in want:
            held.setdefault(kernel, []).append(name)
        return out

    def counted(name, fn, want):
        zero_counts(pk)
        out = fn()
        torch.cuda.synchronize()
        counts[name] = read_counts(pk)
        check_counts(name, counts[name], want)
        return out

    def same_ct(what, x, y):
        same_or_fail(f"{what} (a)", x.a, y.a)
        same_or_fail(f"{what} (b)", x.b, y.b)

    try:
        # (a) the gate keyset through the container
        torch.cuda.reset_peak_memory_stats()
        path = os.path.join(tmp, "l2_gate.mtpu")
        save_s, _ = timed(lambda: io.save(path, {"bk": bk, "ksk": ksk}))
        load_s, keys = timed(lambda: io.load(path))

        def gate(b, k):
            return tlwe.keyswitch(bootstrap.functional_bootstrap(
                tv, cs, b, 4), k)

        out_l = counted("io_gate", lambda: gate(keys["bk"], keys["ksk"]),
                        {"blind_rotate_scan": 1, "tlwe_keyswitch_sum": 1})
        same_ct("gate on the loaded keyset vs in memory", out_l, gate(bk, ksk))
        err = signed_max_abs(tlwe.phase(out_l, key_tlwe) - luts[slots])
        if not err <= KS_DECRYPT_BOUND:
            fail(f"io gate decrypt: max error 2^{err_log2(err):.1f} > 2^60")
        rep["gate"] = {"file_bytes": os.path.getsize(path), "save_s": save_s,
                       "load_s": load_s, "decrypt_max_err_log2": err_log2(err),
                       "peak_bytes": torch.cuda.max_memory_allocated()}
        del keys, out_l
        os.remove(path)
        log(f"# io gate keyset: {rep['gate']['file_bytes']} B, save "
            f"{save_s:.2f} s, load {load_s:.2f} s; {BATCH} gates (1 K1, 1 K2) "
            f"word-equal to the in-memory keyset's; decrypt OK (max err "
            f"2^{err_log2(err):.1f}); peak "
            f"{rep['gate']['peak_bytes'] / 2**30:.2f} GiB")

        # (b) the reference's layouts at L2: u=4 time domain
        bk4 = bootstrap.new_key(gk, key_tlwe, gen, dev, unfolding=U_PBS)
        ex_s, path = timed(lambda: write(
            "u4.bin", lambda f: io.export_mosfhet_bootstrap_key(f, bk4)))
        im_s, bk4_i = timed(lambda: read(
            path, io.import_mosfhet_bootstrap_key))
        if not (torch.equal(bk4_i.su, bk4.su) and bk4_i.primes == bk4.primes):
            fail("u=4 key through save_bootstrap_key's layout != the key")
        out_i = counted("io_u4", lambda: bootstrap.functional_bootstrap(
            tv, cs, bk4_i, 4), {"unfolded_rotate": 1})
        same_ct("u=4 PBS on the imported key vs in memory", out_i,
                bootstrap.functional_bootstrap(tv, cs, bk4, 4))
        rep["u4"] = {"file_bytes": os.path.getsize(path), "export_s": ex_s,
                     "import_s": im_s}
        del bk4, bk4_i, out_i
        os.remove(path)
        log(f"# io u=4 key, time-domain layout: {rep['u4']['file_bytes']} B, "
            f"export {ex_s:.2f} s, import {im_s:.2f} s; su bit for bit; PBS "
            f"of {BATCH} (1 K4) word-equal")

        # u=1 in both f64 DFT layouts
        plan = bk.plan()
        rows = ntt.garner_u64(ntt.inverse_ntt(bk.v, plan), plan)
        for layout in ("ffnt", "spqlios"):
            ex_s, path = timed(lambda: write(
                f"u1_{layout}.bin",
                lambda f: io.export_mosfhet_bootstrap_key(f, bk, layout)))
            im_s, bk_d = timed(lambda: read(
                path, io.import_mosfhet_bootstrap_key_dft, layout))
            if bk_d.primes != bk.primes:
                fail(f"DFT-imported key's primes {bk_d.primes}")
            key_err = signed_max_abs(ntt.garner_u64(
                ntt.inverse_ntt(bk_d.v, plan), plan) - rows)
            out_d = counted(f"io_dft_{layout}",
                            lambda: bootstrap.functional_bootstrap(
                                tv, cs, bk_d, 4), {"blind_rotate_scan": 1})
            err = signed_max_abs(tlwe.phase(out_d, key_out) - luts[slots])
            if not err <= DECRYPT_BOUND:
                fail(f"io u=1 {layout} decrypt: max error "
                     f"2^{err_log2(err):.1f} > 2^58")
            rep[f"u1_{layout}"] = {
                "file_bytes": os.path.getsize(path), "export_s": ex_s,
                "import_s": im_s, "key_word_err_log2": err_log2(key_err),
                "decrypt_max_err_log2": err_log2(err)}
            del bk_d, out_d
            os.remove(path)
            log(f"# io u=1 key, {layout} DFT layout: "
                f"{rep[f'u1_{layout}']['file_bytes']} B, export {ex_s:.2f} s,"
                f" import {im_s:.2f} s; key words within 2^"
                f"{err_log2(key_err):.1f} of the original; PBS of {BATCH} "
                f"(1 K1) decrypt OK (max err 2^{err_log2(err):.1f})")
        del rows

        # phase 15's TRLWE key-switch key in both DFT layouts
        m_ks = rng.uniform_torus(gen, (BATCH, p.N), dev)
        c_ks = trlwe.encrypt(m_ks, key_in, gen)
        ks_plan = ntt.get_plan(p.N, ksk_r.primes, dev)
        ks_words = ntt.from_ntt_u64(ksk_r.v, ks_plan, torch.int64)
        for layout in ("ffnt", "spqlios"):
            ex_s, path = timed(lambda: write(
                f"trlwe_ks_{layout}.bin",
                lambda f: io.export_mosfhet_trlwe_ks_key(f, ksk_r, layout)))
            im_s, ksk_i = timed(lambda: read(
                path, io.import_mosfhet_trlwe_ks_key, layout))
            if ksk_i.primes != ksk_r.primes:
                fail(f"DFT-imported TRLWE KS key's primes {ksk_i.primes}")
            # phase 15's bound with the layout's f64 rounding of the key's
            # words added to its noise
            key_err = signed_max_abs(ntt.from_ntt_u64(
                ksk_i.v, ks_plan, torch.int64) - ks_words)
            rks_bound = trlwe_ks_bound(p, p.l, p.Bg_bit, key_err=key_err)
            out_k = counted(f"io_trlwe_ks_{layout}",
                            lambda: keyswitch.trlwe_keyswitch(c_ks, ksk_i),
                            {"auto_keyswitch_stream": 1})
            err = signed_max_abs(trlwe.phase(out_k, key_trlwe) - m_ks)
            if not err <= rks_bound:
                fail(f"io TRLWE KS {layout} decrypt: max error "
                     f"2^{err_log2(err):.1f} > 2^{math.log2(rks_bound):.0f}")
            rep[f"trlwe_ks_{layout}"] = {
                "file_bytes": os.path.getsize(path), "export_s": ex_s,
                "import_s": im_s, "key_word_err_log2": err_log2(key_err),
                "decrypt_max_err_log2": err_log2(err),
                "decrypt_bound_log2": math.log2(rks_bound)}
            os.remove(path)
            log(f"# io TRLWE KS key, {layout} DFT layout: "
                f"{rep[f'trlwe_ks_{layout}']['file_bytes']} B, export "
                f"{ex_s:.3f} s, import {im_s:.3f} s; key words within 2^"
                f"{err_log2(key_err):.1f}; trlwe_keyswitch of "
                f"{BATCH} (1 K6) decrypt OK (max err 2^{err_log2(err):.1f} "
                f"against 2^{math.log2(rks_bound):.0f})")
        del m_ks, c_ks, out_k, ksk_i, ks_words

        # (c) the reference's own files
        t0 = time.perf_counter()
        ref = {}
        tk = vec("vec2_tlwe_key.bin", io.import_mosfhet_tlwe_key)
        rk = vec("vec2_trlwe_key.bin", io.import_mosfhet_trlwe_key)
        bk2 = vec("vec2_bootstrap_key.bin", io.import_mosfhet_bootstrap_key)
        c_in = vec("vec2_input.bin", io.import_mosfhet_tlwe, tk.n)
        c_ref = vec("vec2_output.bin", io.import_mosfhet_tlwe, rk.k * rk.N)
        lut = torus.double2torus(torch.arange(4, dtype=torch.float64) / 8.0,
                                 dev)
        tv2 = trlwe.torus_packing(lut, rk.k, rk.N)
        out = on_path("io_vec2_u2", lambda: bootstrap.functional_bootstrap(
            tv2, c_in, bk2, 4), {"unfolded_rotate": 1})
        ko = trlwe.extract_tlwe_key(rk)
        ph, ph_ref = tlwe.phase(out, ko), tlwe.phase(c_ref, ko)
        want = torus.double2torus(2 / 8.0, dev)
        d_ref, d_want = torus_dist(ph, ph_ref), torus_dist(ph, want)
        if not (d_ref < 2.0**36 and d_want < 2.0**40):
            fail(f"vec2 bootstrap: 2^{err_log2(d_ref):.1f} from the "
                 f"reference's output, 2^{err_log2(d_want):.1f} from 2/8")
        ref["vec2_u2"] = {"from_reference_log2": err_log2(d_ref),
                          "from_message_log2": err_log2(d_want)}

        for tag, layout in (("v2", "ffnt"), ("v3_sp", "spqlios")):
            tk = vec(f"{tag}_tlwe_key.bin", io.import_mosfhet_tlwe_key)
            ok = vec(f"{tag}_trlwe_okey.bin", io.import_mosfhet_trlwe_key)
            bk1 = vec(f"{tag}_bootstrap_key_u1.bin",
                      io.import_mosfhet_bootstrap_key_dft, layout)
            luts1 = rng.uniform_torus(gen, (4,), dev)
            m = torch.arange(64, device=dev) % 4
            c1 = tlwe.encrypt(torus.double2torus(
                m.to(torch.float64) / 8.0, dev), tk, gen)
            tv1 = trlwe.torus_packing(luts1, VEC_K, VEC_N)
            out = on_path(f"io_{tag}_bk_u1",
                          lambda: bootstrap.functional_bootstrap(
                              tv1, c1, bk1, 4), {"blind_rotate_scan": 1})
            err = signed_max_abs(tlwe.phase(out, trlwe.extract_tlwe_key(ok))
                                 - luts1[m])
            if not err <= DECRYPT_BOUND:
                fail(f"{tag} u=1 key: max error 2^{err_log2(err):.1f} > 2^58")
            ref[f"{tag}_bk_u1"] = {"decrypt_max_err_log2": err_log2(err)}

            ks_key = vec(f"{tag}_trlwe_ks_key.bin",
                         io.import_mosfhet_trlwe_ks_key, layout)
            cin = vec("v2_trlwe_ks_in.bin" if tag == "v2"
                      else "v3_sp_trlwe_sample.bin", io.import_mosfhet_trlwe,
                      VEC_K, VEC_N)
            c_out = vec(f"{tag}_trlwe_ks_out.bin", io.import_mosfhet_trlwe,
                        VEC_K, VEC_N)
            out = on_path(f"io_{tag}_trlwe_ks",
                          lambda: keyswitch.trlwe_keyswitch(cin, ks_key),
                          {"auto_keyswitch_stream": 1})
            msg = torch.arange(VEC_N, device=dev) << 48
            errs = [signed_max_abs(trlwe.phase(c, ok) - msg)
                    for c in (out, c_out)]
            if not max(errs) <= VEC_KS_BOUND:
                fail(f"{tag} TRLWE KS: max errors 2^{err_log2(errs[0]):.1f} "
                     f"(port), 2^{err_log2(errs[1]):.1f} (reference)")
            ref[f"{tag}_trlwe_ks"] = {"decrypt_max_err_log2": err_log2(
                errs[0]), "reference_max_err_log2": err_log2(errs[1])}

        ok = vec("v2_trlwe_okey.bin", io.import_mosfhet_trlwe_key)
        t1 = time.perf_counter()
        pk_key = vec("v2_packing_ks_key.bin", io.import_mosfhet_packing_ks_key,
                     "shake")
        gk_key = vec("v2_generic_ks_key.bin", io.import_mosfhet_generic_ks_key,
                     "shake")
        ref["packing_import_s"] = time.perf_counter() - t1
        ins = vec("v2_packing_in.bin", lambda f: [
            io.import_mosfhet_tlwe(f, 32) for _ in range(4)])
        cs4 = tlwe.TLWE(a=torch.stack([c.a for c in ins]),
                        b=torch.stack([c.b for c in ins]))
        out = on_path("io_v2_packing",
                      lambda: keyswitch.lut_packing_keyswitch(cs4, pk_key),
                      {"tlwe_keyswitch_sum": 1})
        want = torch.repeat_interleave(
            (torch.arange(4, device=dev) + 1) << 60, VEC_N // 4)
        errs = [signed_max_abs(trlwe.phase(c, ok) - want) for c in (
            out, vec("v2_packing_out.bin", io.import_mosfhet_trlwe, VEC_K,
                     VEC_N))]
        gin = vec("v2_generic_in.bin", io.import_mosfhet_tlwe, 32)
        out = on_path("io_v2_generic",
                      lambda: keyswitch.packing1_keyswitch(gin, gk_key),
                      {"tlwe_keyswitch_sum": 1})
        errs += [signed_max_abs(trlwe.phase(c, ok)[:1] - (5 << 60)) for c in (
            out, vec("v2_generic_out.bin", io.import_mosfhet_trlwe, VEC_K,
                     VEC_N))]
        if not max(errs) <= VEC_KS_BOUND:
            fail(f"packing / packing1 keys: max errors "
                 f"{[round(err_log2(e), 1) for e in errs]} (log2)")
        ref["packing"] = {"decrypt_max_err_log2": [err_log2(e)
                                                   for e in errs]}

        vkey = vec("v2_vaes_trlwe_key.bin", io.import_mosfhet_trlwe_key)
        cv = vec("v2_vaes_compressed.bin",
                 io.import_mosfhet_compressed_trlwe_vaes, VEC_K, VEC_N,
                 VEC_AES_KEY)
        err = signed_max_abs(trlwe.phase(cv, vkey) - (
            (3 * torch.arange(VEC_N, device=dev) + 1) << 47))
        if not err <= 2.0**30:
            fail(f"vaes sample: max error 2^{err_log2(err):.1f} > 2^30")
        ref["vaes"] = {"decrypt_max_err_log2": err_log2(err)}

        st = RefStream()
        stream = b"".join(st.bytes(n) for n in [16, 100, 600, 16, 1000, 512,
                                                 3])
        normal = st.normal_torus_array(1.0 / (1 << 15), 256)
        with open(os.path.join(VECTORS, "v3_replay_stream.bin"), "rb") as f:
            ok_stream = stream == f.read()
        with open(os.path.join(VECTORS, "v3_replay_normal.bin"), "rb") as f:
            ok_normal = np.array_equal(normal, np.frombuffer(f.read(), "<u8"))
        s_lwe = st.binary_key(32)
        rk = vec("v3_replay_trlwe_key.bin", io.import_mosfhet_trlwe_key)
        tk = vec("v3_replay_tlwe_key.bin", io.import_mosfhet_tlwe_key)
        if not (ok_stream and ok_normal
                and np.array_equal(tk.s.cpu().numpy(), s_lwe)
                and np.array_equal(rk.s.cpu().numpy(),
                                   st.trlwe_binary_key(VEC_N, VEC_K))):
            fail("RefStream != the reference's replayed stream, noise or keys")
        bkr = vec("v3_replay_bootstrap_key.bin",
                  io.import_mosfhet_bootstrap_key_dft)
        c_in = vec("v3_replay_bs_in.bin", io.import_mosfhet_tlwe, 32)
        c_ref = vec("v3_replay_bs_out.bin", io.import_mosfhet_tlwe, VEC_N)
        tvr = trlwe.noiseless_trivial(
            (torch.arange(VEC_N, device=dev) // (VEC_N // 4) + 1) << 59,
            VEC_K, VEC_N)
        out = on_path("io_v3_replay", lambda: bootstrap.functional_bootstrap(
            tvr, c_in, bkr, 4), {"blind_rotate_scan": 1})
        ko = trlwe.extract_tlwe_key(rk)
        ph = tlwe.phase(out, ko)
        d_ref = torus_dist(ph, tlwe.phase(c_ref, ko))
        d_want = torus_dist(ph, 2 << 59)
        # the key's b words carry the DFT layout's f64 rounding: 2^34.2
        # from the reference's output on the CPU (2^34 with the key rebuilt
        # exactly from the stream, tests/test_replay_vectors.py)
        if not (d_ref < 2.0**36 and d_want < 2.0**52):
            fail(f"replayed bootstrap: 2^{err_log2(d_ref):.1f} from the "
                 f"reference's output, 2^{err_log2(d_want):.1f} from slot 1")
        ref["v3_replay"] = {"from_reference_log2": err_log2(d_ref),
                            "from_message_log2": err_log2(d_want)}
        ref["seconds"] = time.perf_counter() - t0
        rep["reference_files"] = ref
        log(f"# io reference files: vec2 u=2 (K4) 2^"
            f"{ref['vec2_u2']['from_reference_log2']:.1f} from the "
            f"reference's output; u=1 DFT keys (K1) err 2^"
            f"{ref['v2_bk_u1']['decrypt_max_err_log2']:.1f} / 2^"
            f"{ref['v3_sp_bk_u1']['decrypt_max_err_log2']:.1f}; TRLWE KS (K6)"
            f" 2^{ref['v2_trlwe_ks']['decrypt_max_err_log2']:.1f} / 2^"
            f"{ref['v3_sp_trlwe_ks']['decrypt_max_err_log2']:.1f}; packing "
            f"keys (K2, imported in {ref['packing_import_s']:.2f} s); vaes 2^"
            f"{ref['vaes']['decrypt_max_err_log2']:.1f}; replay (K1) 2^"
            f"{ref['v3_replay']['from_reference_log2']:.1f} from the "
            f"reference; each path word-equal on its plain route; "
            f"{ref['seconds']:.1f} s")

        # (d) ufhe at UFHE_SET0: keyset, context and integers
        priv, ctx, ints = (ufhe_keep[k] for k in ("priv", "ctx", "ints"))
        rep["ufhe"] = {"disk_free_bytes": shutil.disk_usage(tmp).free}
        log(f"# io ufhe: {rep['ufhe']['disk_free_bytes'] / 1e9:.1f} GB free")
        torch.cuda.reset_peak_memory_stats()
        loaded = {}
        for name, obj in (("priv", priv), ("ctx", ctx), ("ints", ints)):
            path = os.path.join(tmp, f"ufhe_{name}.mtpu")
            save_s, _ = timed(lambda: io.save(path, obj))
            load_s, loaded[name] = timed(lambda: io.load(path))
            rep["ufhe"][name] = {"file_bytes": os.path.getsize(path),
                                 "save_s": save_s, "load_s": load_s}
            os.remove(path)
        ctx_l, (a_l, b_l) = loaded["ctx"], loaded["ints"]
        same_or_fail("loaded ufhe LUT packing table",
                     ctx_l.keyset.packing_key.table,
                     ctx.keyset.packing_key.table)
        same_or_fail("loaded ufhe extracted key", loaded["priv"].extracted.s,
                     priv.extracted.s)
        d = ints[0].d
        k1, k2 = ufhe_launches("add", d, d + 1, ctx.torus_base)
        out_l = counted("io_ufhe_add", lambda: ufhe.add_integer(
            a_l, b_l, d + 1, ctx_l),
            {"blind_rotate_scan": k1, "tlwe_keyswitch_sum": k2})
        same_ct("ufhe add with the loaded context vs in memory",
                out_l.digits, ufhe.add_integer(ints[0], ints[1], d + 1,
                                               ctx).digits)
        rep["ufhe"]["peak_bytes"] = torch.cuda.max_memory_allocated()
        del loaded, ctx_l, a_l, b_l, out_l
        u = rep["ufhe"]
        log("# io ufhe at UFHE_SET0: " + "; ".join(
            f"{n} {u[n]['file_bytes']} B, save {u[n]['save_s']:.2f} s, load "
            f"{u[n]['load_s']:.2f} s" for n in ("priv", "ctx", "ints"))
            + f"; add of {int(ints[0].digits.b.shape[-1])} pairs with the "
              f"loaded context ({k1} K1,"
              f" {k2} K2) word-equal; peak {u['peak_bytes'] / 2**30:.2f} GiB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 25 (io): {rep['seconds']:.1f} s")
    return rep, counts, held


def set3_phase(dev, max_clock):
    """Phase 19: SET_3, whose shapes put buffers of K1, K3, K4, K7 and K8a
    in a global workspace.  Returns its report and the kernels' entries."""
    from mosfhet_torch import bootstrap, bootstrap_ga, ntt, params, \
        polynomial, rng, tlwe, torus, trgsw, trlwe
    from mosfhet_torch.bootstrap_ga import inverse_mod_2n_table
    from mosfhet_torch.ops import pbs_kernel as pk

    p = params.SET_3
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    key_tlwe = tlwe.new_binary_key(p.n, p.lwe_sigma, gen, dev)
    key_trlwe = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    bk = bootstrap.new_key(trgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe,
                           gen, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_bytes = (bk.v32.numel() + bk.vs32.numel()) * 4
    kp = bk.kernel_plan()
    where = {name: placement(pk, name, kp, **kw) for name, kw in (
        ("blind_rotate", {}), ("ext_product_apply", {}),
        ("unfolded_rotate", {"M": 4}), ("tp_step", {}))}
    log(f"# SET_3 keygen: {keygen_s:.3f} s; key {tuple(bk.v32.shape)} u32 "
        f"x2 = {key_bytes} B; P={kp.P}; placements {where}")
    luts = rng.uniform_torus(gen, (4,), dev)
    tv = trlwe.torus_packing(luts, p.k, p.N)
    slots = torch.arange(BATCH, device=dev) % 4
    cs = tlwe.encrypt(torus.double2torus(slots.to(torch.float64) / 8.0),
                      key_tlwe, gen)
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bootstrap.functional_bootstrap(tv, cs, bk, 4)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pbs_ms, out2 = cuda_ms(
        lambda: bootstrap.functional_bootstrap(tv, cs, bk, 4), REPS)
    counts = read_counts(pk)
    peak = torch.cuda.max_memory_allocated()
    check_counts(f"SET_3 PBS over {1 + REPS} calls", counts,
                 {"blind_rotate_scan": 1 + REPS})
    if out.a.shape != (BATCH, p.k * p.N) or not (
            torch.equal(out.a, out2.a) and torch.equal(out.b, out2.b)):
        fail("SET_3 PBS: wrong shape or repeated calls differ")
    err = signed_max_abs(tlwe.phase(out, key_out) - luts[slots])
    if not err <= DECRYPT_BOUND:
        fail(f"SET_3 decrypt: max error 2^{math.log2(err):.1f} > 2^58")
    acc_in, a_int, _ = bootstrap.blind_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bk, 4), cs.a, bk)
    k1_ms, acc_k = cuda_ms(
        lambda: pk.blind_rotate_scan(acc_in, a_int, bk.v32, bk.vs32, kp),
        REPS)
    k1_plain_ms, acc_p = cuda_ms(
        lambda: pk.blind_rotate_scan_plain(acc_in, a_int, bk.v32, bk.vs32,
                                           kp), 1)
    same_or_fail("SET_3 K1 vs plain on the path's inputs", acc_k, acc_p)
    ext = trlwe.extract_tlwe(trlwe.from_stacked(acc_k), 0)
    if not (torch.equal(ext.a, out.a) and torch.equal(ext.b, out.b)):
        fail("SET_3 PBS output != extract of the kernel's rotation")
    k1_bound = rotation_bound_ms(kp, bk.n, BATCH, key_bytes, max_clock)
    log(f"# SET_3 PBS (n={p.n}, N={p.N}, P={kp.P}): first call "
        f"{first_s:.3f} s; warm {pbs_ms:.3f} ms per batch of {BATCH} = "
        f"{BATCH / pbs_ms * 1e3:.2f} boot/s; decrypt OK (max err "
        f"2^{math.log2(max(err, 1.0)):.1f}); peak {peak / 2**30:.2f} GiB; "
        f"K1 {k1_ms:.3f} ms/launch, plain {k1_plain_ms:.3f} ms, bound "
        f"{k1_bound['bound_ms']:.3f} ms ({k1_bound['bound_by']}); bit-exact")
    del acc_in, a_int, acc_k, acc_p, out, out2

    # K3, K4, K7, K8a at SET_3 widths, cut depth, on random inputs
    rs = np.random.default_rng(SEED + 4)
    J, C, P, N, B = kp.J, kp.C, kp.P, kp.N, SET3_CUT
    acc_r = random_u64(rs, (B, C, N), dev)
    runs = {}

    def held(name, kernel_fn, plain_fn, bound, reps=REPS):
        k_ms, got = cuda_ms(kernel_fn, reps)
        p_ms, want = cuda_ms(plain_fn, 1)
        same_or_fail(f"SET_3 {name} vs plain", got, want)
        runs[name] = {"B": B, "ms": k_ms, "plain_ms": p_ms,
                      "max_abs_err": signed_max_abs(got - want),
                      "bound_ms": bound["bound_ms"],
                      "bound_by": bound["bound_by"]}

    G3 = 2
    for per_row in (False, True):
        rows = (G3, B) if per_row else (G3,)
        sa = random_residues_i32(rs, rows + (J, C, P, N), kp.primes, dev)
        held("ext_product_apply_scan" + ("/per_row" if per_row else ""),
             lambda: pk.ext_product_apply_scan(acc_r, sa, kp, per_row),
             lambda: pk.ext_product_apply_scan_plain(acc_r, sa, kp, per_row),
             apply_scan_bound(kp, B, G3, per_row, max_clock))
    del sa
    M4 = 4                                    # u = 2
    su = random_u64(rs, (G3, M4, J, C, N), dev)
    rot = random_exponents(rs, B, G3, M4, N, dev)
    held("unfolded_rotate", lambda: pk.unfolded_rotate(acc_r, rot, su, kp),
         lambda: pk.unfolded_rotate_plain(acc_r, rot, su, kp),
         unfolded_bound(kp, B, G3, M4, max_clock))
    del su, rot
    n7, G7 = 4, SET3_GA_ENTRIES
    ks_primes = ntt.primes_for_bound(ntt.conv_bound(
        N, 1 << (p.Bg_bit - 1), p.k * p.l * p.l))
    kp_ks = pk.get_kernel_plan(N, ks_primes, p.l, p.Bg_bit, p.k, dev)
    sv = random_residues_i32(rs, (n7, J, C, P, N), kp.primes, dev)
    svs = pk.u32_as_i32(torch.div(pk.i32_as_u32(sv) << 32,
                                  kp.ntt.p[:, None], rounding_mode="floor"))
    ak = random_residues_i32(rs, (G7, p.k * p.l, C, kp_ks.P, N), ks_primes,
                             dev)
    gens = torch.from_numpy(rs.integers(0, G7, (n7, B), dtype=np.int32) * 2
                            + 1).to(dev)
    gens[0, 0], gens[-1, -1] = 1, 2 * G7 - 1
    inv2n = torch.from_numpy(inverse_mod_2n_table(N)).to(dev)
    held("ga_scan_fused",
         lambda: pk.ga_scan_fused(acc_r, gens, sv, svs, ak, inv2n, kp, kp_ks),
         lambda: pk.ga_scan_fused_plain(acc_r, gens, sv, svs, ak, inv2n, kp,
                                        kp_ks),
         ga_bound(kp, kp_ks, gens, max_clock))
    where["ga_scan"] = placement(pk, "ga_scan", kp, P_ks=kp_ks.P)
    del sv, svs, ak
    a_r = torch.from_numpy(rs.integers(0, 2 * N + 1, B, dtype=np.int32)).to(
        dev)
    kv = bk.v32[0].contiguous()
    kvs = bk.vs32[0].contiguous()
    for j0, j_local in ((0, J), (J // 2, J - J // 2)):
        rows_v = kv[j0:j0 + j_local].contiguous()
        rows_s = kvs[j0:j0 + j_local].contiguous()
        held(f"partial_step/rows{j0}-{j0 + j_local}",
             lambda: pk.partial_step(acc_r, a_r, j0, rows_v, rows_s, kp),
             lambda: pk.partial_step_plain(acc_r, a_r, j0, rows_v, rows_s,
                                           kp),
             partial_step_bound(kp, B, j_local, max_clock))
    k8_res = k8_residency(pk, kp, 64, "SET_3")
    k34_res = k3_k4_residency(pk, kp, 64, M4, "SET_3")
    log("# SET_3 K3 (broadcast, per row; G=2), K4 (u=2, G=2), K7 (n=4, "
        f"{G7} keyset entries, P_ks={kp_ks.P}) and K8a at B={B}: "
        + "; ".join(f"{name} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
                    f"bound {r['bound_ms']:.4f} {r['bound_by']})"
                    for name, r in runs.items()) + "; bit-exact")
    # K1-step and K3-step: rot in the workspace, acc in the caller's tensor
    a_np = rs.integers(0, 2 * N + 1, B, dtype=np.int32)
    a_np[:3] = [0, N, 2 * N]
    a_s = torch.from_numpy(a_np).to(dev)
    hold_in_place(runs, "pbs_step",
                  lambda acc: pk.pbs_step(acc, a_s, kv, kvs, kp),
                  lambda acc: pk.pbs_step_plain(acc, a_s, kv, kvs, kp),
                  acc_r, step_bound_ms(kp, B, max_clock), REPS)
    for per_row in (False, True):
        key_s = random_residues_i32(
            rs, ((B,) if per_row else ()) + (J, C, P, N), kp.primes, dev)
        hold_in_place(runs, "ext_product_apply_step"
                      + ("/per_row" if per_row else ""),
                      lambda acc: pk.ext_product_apply_step(acc, key_s, kp,
                                                            per_row),
                      lambda acc: pk.ext_product_apply_step_plain(
                          acc, key_s, kp, per_row),
                      acc_r, apply_scan_bound(kp, B, 1, per_row, max_clock),
                      REPS)
    for name in ("pbs_step", "ext_product_apply_step",
                 "ext_product_apply_step/per_row"):
        runs[name]["B"] = B
    where["pbs_step"] = placement(pk, "pbs_step", kp, source="blind_rotate")
    where["ext_product_apply_step"] = placement(pk, "ext_product_apply", kp)
    log(f"# SET_3 K1-step and K3-step at B={B}: placements "
        f"{where['pbs_step']}, {where['ext_product_apply_step']}; "
        + "; ".join(f"{name} {runs[name]['ms']:.4f} ms (plain "
                    f"{runs[name]['plain_ms']:.3f}, bound "
                    f"{runs[name]['bound_ms']:.4f} {runs[name]['bound_by']})"
                    for name in ("pbs_step", "ext_product_apply_step",
                                 "ext_product_apply_step/per_row"))
        + "; bit-exact")
    del acc_r, kv, kvs, key_s

    # the GA bootstrap at SET_3: K6 (perm in the workspace), then K7
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bkg = bootstrap_ga.new_key(trgsw.new_key(key_trlwe, p.l, p.Bg_bit),
                               key_tlwe, gen, dev)
    torch.cuda.synchronize()
    ga_keygen_s = time.perf_counter() - t0
    ga_key_bytes = sum(t.numel() * t.element_size()
                       for t in (bkg.s_v32, bkg.s_vs32, bkg.ak, bkg.inv2n))
    zero_counts(pk)
    out_g = bootstrap_ga.functional_bootstrap_ga(tv, cs, bkg, 4)
    ga_ms, out_g2 = cuda_ms(
        lambda: bootstrap_ga.functional_bootstrap_ga(tv, cs, bkg, 4), REPS)
    ga_counts = read_counts(pk)
    check_counts(f"SET_3 GA path over {1 + REPS} calls", ga_counts,
                 {"auto_keyswitch_stream": 1 + REPS,
                  "ga_scan_fused": 1 + REPS})
    if not (torch.equal(out_g.a, out_g2.a) and torch.equal(out_g.b, out_g2.b)):
        fail("repeated SET_3 GA bootstraps of the same inputs differ")
    ga_err = signed_max_abs(tlwe.phase(out_g, key_out) - luts[slots])
    if not ga_err <= DECRYPT_BOUND:
        fail(f"SET_3 GA decrypt: max error 2^{math.log2(ga_err):.1f} > 2^58")
    acc_g, kidx0, ginv0, gens0, _ = bootstrap_ga.ga_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bkg, 4), cs.a, bkg)
    kpg, kpg_ks = bkg.kernel_plans()
    B = BATCH
    held("auto_keyswitch_stream/ga_path",
         lambda: pk.auto_keyswitch_stream(acc_g, bkg.ak, kidx0, ginv0,
                                          kpg_ks),
         lambda: pk.auto_keyswitch_stream_plain(acc_g, bkg.ak, kidx0, ginv0,
                                                kpg_ks),
         auto_ks_bound(kpg_ks, BATCH, kidx0, max_clock), reps=KS_REPS)
    where["auto_keyswitch"] = placement(pk, "auto_keyswitch_stream", kpg_ks,
                                        "auto_keyswitch")
    # K6-old (K6's kernel, entry b, ginv 1) on that key switch's rows
    # permuted and their keyset entries gathered: x read in place
    perm = polynomial.permute_by_inverse(
        acc_g, ginv0.to(torch.int64)[:, None]).contiguous()
    rows = bkg.ak[kidx0.to(torch.int64)]
    # one untimed launch first: the runtime loads a kernel instance at its
    # first launch, and no SET_3 path has launched this one yet
    pk.auto_keyswitch(perm, rows, kpg_ks)
    held("auto_keyswitch/ga_path",
         lambda: pk.auto_keyswitch(perm, rows, kpg_ks),
         lambda: pk.auto_keyswitch_plain(perm, rows, kpg_ks),
         auto_ks_gathered_bound(kpg_ks, BATCH, max_clock), reps=KS_REPS)
    # K6's own instances on the gathered rows (entry b, ginv 1): the same
    # words and data, so the two times differ by the instance alone
    iota = torch.arange(B, dtype=torch.int32, device=dev)
    k6_rows_ms, o_6 = cuda_ms(lambda: pk.auto_keyswitch_stream(
        perm, rows, iota, torch.ones_like(iota), kpg_ks), KS_REPS)
    runs["auto_keyswitch/ga_path"]["k6_on_the_rows_ms"] = k6_rows_ms
    same_or_fail("SET_3 K6-old vs K6 on the gathered rows",
                 pk.auto_keyswitch(perm, rows, kpg_ks), o_6)
    same_or_fail("SET_3 K6-old vs K6 on the GA path's inputs", o_6,
                 pk.auto_keyswitch_stream(acc_g, bkg.ak, kidx0, ginv0,
                                          kpg_ks))
    del perm, rows, iota, o_6
    runs["auto_keyswitch/ga_path"]["resident_blocks_per_sm"] = residency(
        *pk.auto_keyswitch_residency(kpg_ks, 64, gathered=True),
        f"K6-old at N={kpg_ks.N}, P={kpg_ks.P}")["blocks_per_sm"]
    k6_res = k6_residency(pk, kpg_ks, 64, "SET_3")
    k7_res = k7_residency(pk, kpg, kpg_ks, 64)
    log(f"# SET_3 K7 residency: {k7_res['blocks_per_sm']} blocks of "
        f"{k7_res['threads_per_block']} threads per SM, placement "
        f"{placement(pk, 'ga_scan', kpg, P_ks=kpg_ks.P)}")
    log(f"# SET_3 GA bootstrap (P_ks={kpg_ks.P}): keygen {ga_keygen_s:.3f} "
        f"s, {ga_key_bytes} B; warm {ga_ms:.3f} ms per batch of {BATCH} = "
        f"{BATCH / ga_ms * 1e3:.2f} boot/s; decrypt OK (max err "
        f"2^{math.log2(max(ga_err, 1.0)):.1f}); K6 "
        f"{runs['auto_keyswitch_stream/ga_path']['ms']:.3f} ms/launch "
        f"(plain {runs['auto_keyswitch_stream/ga_path']['plain_ms']:.3f}), "
        f"placement {where['auto_keyswitch']}; K6-old "
        f"{runs['auto_keyswitch/ga_path']['ms']:.4f} ms/launch (plain "
        f"{runs['auto_keyswitch/ga_path']['plain_ms']:.3f}, bound "
        f"{runs['auto_keyswitch/ga_path']['bound_ms']:.4f} "
        f"{runs['auto_keyswitch/ga_path']['bound_by']}), the same placement, "
        f"{runs['auto_keyswitch/ga_path']['resident_blocks_per_sm']} blocks "
        f"per SM, K6's words (K6 on the gathered rows {k6_rows_ms:.4f} "
        f"ms/launch); bit-exact")
    del bkg, acc_g, out_g, out_g2
    report = {"params": p.name, "batch": BATCH, "P": kp.P,
              "keygen_s": keygen_s, "key_bytes": key_bytes,
              "first_call_s": first_s, "warm_ms": pbs_ms,
              "boot_per_s": BATCH / pbs_ms * 1e3, "peak_bytes": peak,
              "decrypt_max_err_log2": math.log2(max(err, 1.0)),
              "rotation_ms": k1_ms, "glue_ms": pbs_ms - k1_ms,
              "bound": k1_bound, "placements": where, "kernel_runs": runs,
              "ga": {"keygen_s": ga_keygen_s, "key_bytes": ga_key_bytes,
                     "warm_ms": ga_ms, "boot_per_s": BATCH / ga_ms * 1e3,
                     "decrypt_max_err_log2": math.log2(max(ga_err, 1.0)),
                     "counts": ga_counts, "k6_residency": k6_res,
                     "k7_residency": k7_res},
              "k8_residency": k8_res, "k3_k4_residency": k34_res}
    k1_entry = {
        "name": "blind_rotate_scan/set3", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/blind_rotate.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1404",
        "launches": counts["blind_rotate_scan"],
        "launches_by_path": {"set3": counts["blind_rotate_scan"]},
        "max_abs_err": 0.0, "bit_exact": True, "ms": k1_ms,
        "plain_ms": k1_plain_ms, "bound_ms": k1_bound["bound_ms"],
        "bound_by": k1_bound["bound_by"], "library_ms": None,
        "placement": where["blind_rotate"]}
    return report, k1_entry, runs


def n8192_phase(dev, max_clock):
    """Phase 19b: K8b at N=8192 with 4 primes (SET_3's digits, 64-bit
    torus), whose C*P spectra (256 KiB) exceed a block: pbs_on_mesh on a
    (1, 2) mesh of the card with a random key cut to N8192_DEPTH steps, on
    N8192_BATCH random ciphertexts, word-equal to K1's bootstrap; then K8b
    on that path's first step, and on 4 random partials, held to its plain
    version.  Returns the K8b entry of the kernels line."""
    from mosfhet_torch import bootstrap, ntt, trlwe
    from mosfhet_torch.ops import pbs_kernel as pk
    from mosfhet_torch.parallel import mesh as pmesh
    from mosfhet_torch.tlwe import TLWE

    N, k, l, Bg_bit, n, B = 8192, 1, 1, 22, N8192_DEPTH, N8192_BATCH
    primes = ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, k))
    kp = pk.get_kernel_plan(N, primes, l, Bg_bit, k, dev)
    if kp.P != 4:
        fail(f"N=8192 plan has {kp.P} primes, want 4")
    rs = np.random.default_rng(SEED + 8192)
    C, J, P = kp.C, kp.J, kp.P
    kv = random_residues_i32(rs, (n, J, C, P, N), primes, dev)
    kvs = pk.u32_as_i32(torch.div(pk.i32_as_u32(kv) << 32, kp.ntt.p[:, None],
                                  rounding_mode="floor"))
    bk = bootstrap.BootstrapKey(kv, kvs, n, k, N, l, Bg_bit, primes)
    c = TLWE(a=random_u64(rs, (B, n), dev), b=random_u64(rs, (B,), dev))
    tv = trlwe.torus_packing(random_u64(rs, (4,), dev), k, N)
    want = bootstrap.functional_bootstrap(tv, c, bk, 4)
    run = pmesh.pbs_on_mesh(pmesh.make_mesh([dev] * 2, data=1, model=2),
                            bk, 4)
    zero_counts(pk)
    got = run(tv, c)
    torch.cuda.synchronize()
    counts = read_counts(pk)
    check_counts("N=8192 pbs_on_mesh (1 x 2)", counts,
                 {"partial_step": 2 * n, "finish_step": n})
    if not (torch.equal(got.a, want.a) and torch.equal(got.b, want.b)):
        fail("N=8192 pbs_on_mesh (1 x 2) != K1's bootstrap")
    acc_in, a_int, _ = bootstrap.blind_rotate_inputs(
        bootstrap.rotate_test_vector(tv, c, bk, 4), c.a, bk)
    parts = torch.empty((2, B, C, P, N), dtype=torch.int32, device=dev)
    jl = J // 2
    for sh in range(2):
        pk.partial_step(acc_in, a_int[0].contiguous(), sh * jl,
                        kv[0, sh * jl:(sh + 1) * jl].contiguous(),
                        kvs[0, sh * jl:(sh + 1) * jl].contiguous(), kp,
                        out=parts[sh])
    acc_f = acc_in.clone()
    k8b_ms, _ = queued_ms(lambda: pk.finish_step(acc_f, parts, kp),
                          TP_REPS)
    acc_k = pk.finish_step(acc_in.clone(), parts, kp)
    plain_ms, acc_p = cuda_ms(
        lambda: pk.finish_step_plain(acc_in.clone(), parts, kp), 1)
    same_or_fail("K8b at N=8192 on the path's inputs", acc_k, acc_p)
    parts4 = random_residues_i32(rs, (4, B, C, P, N), primes, dev)
    parts4[:, 0, 0, :, 0] = pk.u32_as_i32(kp.ntt.p - 1)
    same_or_fail("K8b at N=8192 on 4 random partials",
                 pk.finish_step(acc_in.clone(), parts4, kp),
                 pk.finish_step_plain(acc_in.clone(), parts4, kp))
    bound = finish_step_bound(kp, B, 2, max_clock)
    where = placement(pk, "finish_step", kp, source="tp_step")
    k8_res = k8_residency(pk, kp, 64, "N=8192")
    log(f"# N=8192 (P=4) pbs_on_mesh (1 x 2), n={n}, B={B}: {2 * n} K8a + "
        f"{n} K8b launches, words equal to K1's; K8b placement {where}; K8b "
        f"{k8b_ms:.4f} ms/launch on 2 partials (mean of {TP_REPS}), plain "
        f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}); bit-exact, and on 4 random partials")
    return {
        "name": "finish_step/n8192", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/tp_step.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1651",
        "launches": counts["finish_step"],
        "launches_by_path": {"mesh_1x2_n8192": counts["finish_step"]},
        "max_abs_err": 0.0, "bit_exact": True, "ms": k8b_ms,
        "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "library_note": TP_LIBRARY_NOTE, "placement": where, "B": B,
        "k8_residency": k8_res}


def torus32_phase():
    """Phase 20: run this script as a child at the 32-bit torus; relay its
    log; return its report (the last line of its output)."""
    env = dict(os.environ, MOSFHET_TORUS_BITS="32")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--torus32"], env=env, capture_output=True,
                       text=True, timeout=TORUS32_TIMEOUT_S)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"# [torus32] {line.lstrip('# ')}")
    if r.returncode != 0 or not lines:
        print(r.stderr[-4000:], file=sys.stderr)
        fail(f"the TORUS32 child exited with {r.returncode}")
    return json.loads(lines[-1])


def torus32_main():
    """The child of phase 20: the port imported at the 32-bit torus."""
    from mosfhet_torch import bootstrap, ntt, params, rng, tlwe, torus, \
        trgsw, trlwe
    from mosfhet_torch.ops import pbs_kernel as pk

    if torus.TORUS_BITS != 32 or torus.TORUS_DTYPE != torch.int32:
        fail("the TORUS32 child needs MOSFHET_TORUS_BITS=32")
    dev = torch.device("cuda")
    max_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    p = params.TFHEParams(**L2_32)
    primes = ntt.primes_for_bound(
        ntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    kp = pk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, dev)
    rs = np.random.default_rng(SEED + 32)

    # K1 and K2's one-limb forms vs plain on random inputs
    n_short, b_short = 8, 4
    acc0 = torch.from_numpy(rs.integers(0, 1 << 32, (b_short, kp.C, p.N),
                                        dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)
    a_np = rs.integers(0, 2 * p.N + 1, (n_short, b_short), dtype=np.int32)
    a_np[0, 0], a_np[1, 1], a_np[-1, -1] = 0, 2 * p.N, p.N
    a_short = torch.from_numpy(a_np).to(dev)
    kv32 = random_residues_i32(rs, (n_short, kp.J, kp.C, kp.P, p.N), primes,
                               dev)
    kvs32 = pk.u32_as_i32(torch.div(pk.i32_as_u32(kv32) << 32,
                                    kp.ntt.p[:, None], rounding_mode="floor"))
    same_or_fail("K1/torus32 vs plain on random inputs",
                 pk.blind_rotate_scan(acc0, a_short, kv32, kvs32, kp),
                 pk.blind_rotate_scan_plain(acc0, a_short, kv32, kvs32, kp))
    n_in, base_m1 = p.k * p.N, (1 << p.base_bit) - 1
    dig_np = rs.integers(0, base_m1 + 1, (b_short, n_in, p.t), dtype=np.int32)
    dig_np[0, 0, 0], dig_np[-1, -1, -1] = 0, base_m1
    ab_rand = torch.from_numpy(rs.integers(
        0, 1 << 32, (n_in, p.t, base_m1, p.n + 1), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)
    d = torch.from_numpy(dig_np).to(dev)
    same_or_fail("K2/torus32 vs plain on random inputs",
                 pk.tlwe_keyswitch_sum(d, ab_rand),
                 pk.tlwe_keyswitch_sum_plain(d, ab_rand))
    del ab_rand
    log(f"# K1 (n={n_short}, B={b_short}) and K2 (B={b_short}) one-limb "
        f"forms vs plain at L2_32 widths: bit-exact")

    # keygen and the PBS through the entry points
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    key_tlwe = tlwe.new_binary_key(p.n, p.lwe_sigma, gen, dev)
    key_trlwe = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    gk = trgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = bootstrap.new_key(gk, key_tlwe, gen, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_bytes = (bk.v32.numel() + bk.vs32.numel()) * 4
    if bk.primes != primes:
        fail(f"L2_32 key primes {bk.primes}, want {primes}")
    kp = bk.kernel_plan()
    log(f"# L2_32 keygen: {keygen_s:.3f} s; primes {primes}; key "
        f"{tuple(bk.v32.shape)} u32 x2 = {key_bytes} B; K1 placement "
        f"{placement(pk, 'blind_rotate', kp)}")
    luts = rng.uniform_torus(gen, (4,), dev)
    tv = trlwe.torus_packing(luts, p.k, p.N)
    slots = torch.arange(BATCH, device=dev) % 4
    cs = tlwe.encrypt(torus.double2torus(slots.to(torch.float64) / 8.0),
                      key_tlwe, gen)
    if cs.b.dtype != torch.int32 or tv.b.dtype != torch.int32:
        fail("L2_32 words are not int32")
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bootstrap.functional_bootstrap(tv, cs, bk, 4)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pbs_ms, out2 = cuda_ms(
        lambda: bootstrap.functional_bootstrap(tv, cs, bk, 4), REPS)
    pbs_counts = read_counts(pk)
    pbs_peak = torch.cuda.max_memory_allocated()
    check_counts(f"L2_32 PBS over {1 + REPS} calls", pbs_counts,
                 {"blind_rotate_scan": 1 + REPS})
    if out.a.shape != (BATCH, p.k * p.N) or out.a.dtype != torch.int32 or \
            not (torch.equal(out.a, out2.a) and torch.equal(out.b, out2.b)):
        fail("L2_32 PBS: wrong shape or dtype, or repeated calls differ")
    err = signed_max_abs(tlwe.phase(out, key_out) - luts[slots])
    if not err < DECRYPT_BOUND_32:
        fail(f"L2_32 decrypt: max error 2^{math.log2(err):.1f} >= 2^26")
    acc_in, a_int, _ = bootstrap.blind_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bk, 4), cs.a, bk)
    k1_ms, acc_k = cuda_ms(
        lambda: pk.blind_rotate_scan(acc_in, a_int, bk.v32, bk.vs32, kp),
        REPS)
    k1_plain_ms, acc_p = cuda_ms(
        lambda: pk.blind_rotate_scan_plain(acc_in, a_int, bk.v32, bk.vs32,
                                           kp), 1)
    same_or_fail("K1/torus32 vs plain on the path's inputs", acc_k, acc_p)
    ext = trlwe.extract_tlwe(trlwe.from_stacked(acc_k), 0)
    if not (torch.equal(ext.a, out.a) and torch.equal(ext.b, out.b)):
        fail("L2_32 PBS output != extract of the kernel's rotation")
    k1_bound = rotation_bound_ms(kp, bk.n, BATCH, key_bytes, max_clock)
    log(f"# L2_32 PBS: first call {first_s:.3f} s; warm {pbs_ms:.3f} ms per "
        f"batch of {BATCH} = {BATCH / pbs_ms * 1e3:.2f} boot/s; decrypt OK "
        f"(max err 2^{math.log2(max(err, 1.0)):.1f}); peak "
        f"{pbs_peak / 2**30:.2f} GiB; K1 {k1_ms:.3f} ms/launch, plain "
        f"{k1_plain_ms:.3f} ms, bound {k1_bound['bound_ms']:.3f} ms "
        f"({k1_bound['bound_by']}: {k1_bound['multiplies']:.4g} int32 "
        f"multiplies); bit-exact")
    k1_res = k1_residency(pk, kp, 32)
    k1_curve = wave_curve(
        lambda acc, a: pk.blind_rotate_scan(acc, a, bk.v32, bk.vs32, kp),
        acc_in, a_int, k1_res["K1"]["resident_ciphertexts"])
    log_wave_curve("L2_32", "K1", k1_res["K1"], k1_curve,
                   f"; K1-step {k1_res['K1-step']['blocks_per_sm']}")
    steps, steps_counts, steps_runs = rotation_steps_phase(
        bk, tv, cs, acc_k, k1_ms, max_clock)
    del acc_in, a_int, acc_k, acc_p

    # the gate's key switch, then fdfb_this_work
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ksk = tlwe.new_ks_key(key_tlwe, key_out, p.t, p.base_bit, gen, dev)
    torch.cuda.synchronize()
    ks_keygen_s = time.perf_counter() - t0
    ks_key_bytes = ksk.ab.numel() * ksk.ab.element_size()
    zero_counts(pk)
    ks_out = tlwe.keyswitch(out, ksk)
    torch.cuda.synchronize()
    gate_counts = read_counts(pk)
    check_counts("L2_32 gate", gate_counts, {"tlwe_keyswitch_sum": 1})
    ks_err = signed_max_abs(tlwe.phase(ks_out, key_tlwe) - luts[slots])
    if not ks_err < KS_DECRYPT_BOUND_32:
        fail(f"L2_32 gate decrypt: max error 2^{math.log2(ks_err):.1f}")
    dig = tlwe.keyswitch_inputs(out, ksk)
    k2_gate, sub_k = k2_report(pk, "L2_32 gate", dig, ksk.ab, max_clock)
    k2_ms, k2_bound = k2_gate["ms"], k2_gate["bound"]
    k2_plain_ms, sub_p = cuda_ms(
        lambda: pk.tlwe_keyswitch_sum_plain(dig, ksk.ab), 1)
    same_or_fail("K2/torus32 vs plain on the gate's inputs", sub_k, sub_p)
    library, library_note = sparse_select_sum(dig, ksk.ab)
    library_ms = None
    if library is not None:
        library_ms, sub_l = cuda_ms(library, KS_REPS)
        same_or_fail("torch.sparse.mm select-sum vs K2/torus32", sub_l, sub_k)
        del sub_l
    log(f"# library call: {library_note}"
        + (f": {library_ms:.3f} ms" if library_ms is not None else ""))
    log(f"# L2_32 gate: KS keygen {ks_keygen_s:.3f} s, table "
        f"{tuple(ksk.ab.shape)} int32 = {ks_key_bytes} B; decrypt OK (max "
        f"err 2^{math.log2(max(ks_err, 1.0)):.1f}); K2 {k2_ms:.3f} ms/launch "
        f"(one launch, then the mean of {KS_REPS}), plain "
        f"{k2_plain_ms:.3f} ms, bound "
        f"{k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']}); bit-exact")
    del dig, sub_k, sub_p
    luts8 = rng.uniform_torus(gen, (8,), dev)
    tv8 = trlwe.torus_packing_many_lut(luts8, 4, 2, p.k, p.N)
    m8 = torch.arange(BATCH, device=dev) % 8
    c8 = tlwe.encrypt(torus.int2torus(m8, FDFB_PREC), key_tlwe, gen)
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out8 = bootstrap.fdfb_this_work(tv8, c8, bk, ksk, FDFB_PREC)
    torch.cuda.synchronize()
    fdfb_first_s = time.perf_counter() - t0
    fdfb_ms, out8b = cuda_ms(
        lambda: bootstrap.fdfb_this_work(tv8, c8, bk, ksk, FDFB_PREC), REPS)
    fdfb_counts = read_counts(pk)
    fdfb_peak = torch.cuda.max_memory_allocated()
    calls = 1 + REPS
    check_counts(f"L2_32 fdfb over {calls} calls", fdfb_counts,
                 {"blind_rotate_scan": 2 * calls, "tlwe_keyswitch_sum": calls})
    if not (torch.equal(out8.a, out8b.a) and torch.equal(out8.b, out8b.b)):
        fail("repeated L2_32 fdfb calls on the same inputs differ")
    fdfb_err = signed_max_abs(tlwe.phase(out8, key_out) - luts8[m8])
    if not fdfb_err < DECRYPT_BOUND_32:
        fail(f"L2_32 fdfb decrypt: max error 2^{math.log2(fdfb_err):.1f}")
    log(f"# L2_32 fdfb_this_work: first call {fdfb_first_s:.3f} s; warm "
        f"{fdfb_ms:.3f} ms per batch of {BATCH} = "
        f"{BATCH / fdfb_ms * 1e3:.2f} fdfb/s (2 x K1 {k1_ms:.3f} + K2 "
        f"{k2_ms:.3f} + glue {fdfb_ms - 2 * k1_ms - k2_ms:.3f} ms); decrypt "
        f"OK (max err 2^{math.log2(max(fdfb_err, 1.0)):.1f}); peak "
        f"{fdfb_peak / 2**30:.2f} GiB")
    dig = fdfb_ks_digits(bootstrap, tlwe, trlwe, torus, c8, bk, ksk,
                         FDFB_PREC)
    k2_fdfb, sub_k = k2_report(pk, "L2_32 fdfb", dig, ksk.ab, max_clock)
    same_or_fail("K2/torus32 vs plain on the fdfb's key-switch inputs",
                 sub_k, pk.tlwe_keyswitch_sum_plain(dig, ksk.ab))
    del dig, sub_k
    unfolded = torus32_unfolded(p, dev, max_clock, gen, gk, key_tlwe,
                                key_trlwe, key_out, tv, luts, cs, slots)
    mesh = torus32_mesh(p, dev, max_clock, bk, tv, cs, out, unfolded)
    ga = torus32_ga(p, dev, max_clock, gen, gk, key_tlwe, key_trlwe, key_out,
                    tv, luts, cs, slots, out)
    matrix, matrix_counts = trgsw_matrix_phase(p, gk, gen, dev, max_clock,
                                               "L2_32")
    ksf, ksf_counts, ksf_runs, ksf_tables = ks_family32_phase(
        p, key_trlwe, gen, dev, max_clock)
    fam, fam_counts, fam_runs = boot_family32_phase(
        p, key_tlwe, key_trlwe, gk, bk, luts, gen, dev, max_clock,
        ksf_tables)
    print(json.dumps({
        "params": p.name, "batch": BATCH, "primes": list(primes),
        "keygen_s": keygen_s, "key_bytes": key_bytes,
        "pbs": {"first_call_s": first_s, "warm_ms": pbs_ms,
                "boot_per_s": BATCH / pbs_ms * 1e3, "peak_bytes": pbs_peak,
                "decrypt_max_err_log2": math.log2(max(err, 1.0)),
                "glue_ms": pbs_ms - k1_ms},
        "gate": {"ks_keygen_s": ks_keygen_s, "ks_key_bytes": ks_key_bytes,
                 "decrypt_max_err_log2": math.log2(max(ks_err, 1.0))},
        "fdfb": {"first_call_s": fdfb_first_s, "warm_ms": fdfb_ms,
                 "fdfb_per_s": BATCH / fdfb_ms * 1e3, "peak_bytes": fdfb_peak,
                 "decrypt_max_err_log2": math.log2(max(fdfb_err, 1.0)),
                 "glue_ms": fdfb_ms - 2 * k1_ms - k2_ms},
        "counts": {"pbs": pbs_counts, "gate": gate_counts,
                   "fdfb": fdfb_counts, "steps": steps_counts,
                   **unfolded.pop("counts"), **mesh.pop("counts"),
                   **ga.pop("counts"), "trgsw_matrix": matrix_counts,
                   **ksf_counts, **{f"family_{name}": c
                                    for name, c in fam_counts.items()}},
        "steps": steps, "trgsw_matrix": matrix, "ks_family": ksf,
        "ks_family_runs": ksf_runs, "boot_family": fam,
        "family_runs": fam_runs,
        "k1": {"ms": k1_ms, "plain_ms": k1_plain_ms, "bound": k1_bound,
               "residency": k1_res, "wave_curve": k1_curve},
        "k2": {"gate": k2_gate, "fdfb": k2_fdfb, "plain_ms": k2_plain_ms,
               "library_ms": library_ms, "library_note": library_note},
        "kernel_runs": {**unfolded.pop("kernel_runs"),
                        **mesh.pop("kernel_runs"), **ga.pop("kernel_runs"),
                        **steps_runs},
        **unfolded, "mesh": mesh, **ga}))
    return 0


def hold(runs, name, kernel_fn, plain_fn, bound, reps=REPS, timer=None):
    """The kernel (timed over reps by ``timer``, `cuda_ms` by default) and
    its plain version (once) on the same inputs, word for word, recorded in
    ``runs[name]``; returns the kernel's output."""
    k_ms, got = (timer or cuda_ms)(kernel_fn, reps)
    p_ms, want = cuda_ms(plain_fn, 1)
    same_or_fail(f"{name} vs plain on the path's inputs", got, want)
    runs[name] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": 0.0,
                  "bound_ms": bound["bound_ms"],
                  "bound_by": bound["bound_by"], "bound": bound}
    return got


def torus32_unfolded(p, dev, max_clock, gen, gk, key_tlwe, key_trlwe,
                     key_out, tv, luts, cs, slots):
    """Phase 20's unfolded paths at L2_32: the u=4 PBS (K4), UBR at u=4
    (K5, then K3) and the external product (K3), each through its entry
    point with exact launch counts and a decrypt check, and each kernel
    held to its plain version on the path's own inputs.  Returns the
    report, with the paths' counts and the kernels' runs."""
    from mosfhet_torch import bootstrap, rng, tlwe, torus, trgsw, trlwe
    from mosfhet_torch.ops import pbs_kernel as pk

    runs, counts = {}, {}

    def held(*args, **kw):
        return hold(runs, *args, **kw)

    # the u=4 PBS on the PBS's LUT and ciphertexts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bk4 = bootstrap.new_key(gk, key_tlwe, gen, dev, unfolding=U_PBS)
    torch.cuda.synchronize()
    keygen4_s = time.perf_counter() - t0
    su4_bytes = bk4.su.numel() * bk4.su.element_size()
    if bk4.su.dtype != torch.int32:
        fail(f"L2_32 unfolded key words are {bk4.su.dtype}")
    kp4 = bk4.kernel_plan()
    log(f"# L2_32 unfolded keygen (u={U_PBS}): {keygen4_s:.3f} s; key "
        f"{tuple(bk4.su.shape)} u32 = {su4_bytes} B; K4 placement "
        f"{placement(pk, 'unfolded_rotate', kp4, M=1 << U_PBS)}")
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out4 = bootstrap.functional_bootstrap(tv, cs, bk4, 4)
    torch.cuda.synchronize()
    first4_s = time.perf_counter() - t0
    ub_ms, out4b = cuda_ms(
        lambda: bootstrap.functional_bootstrap(tv, cs, bk4, 4), REPS)
    counts["unfolded"] = read_counts(pk)
    ub_peak = torch.cuda.max_memory_allocated()
    check_counts(f"L2_32 unfolded path over {1 + REPS} calls",
                 counts["unfolded"], {"unfolded_rotate": 1 + REPS})
    if out4.a.shape != (BATCH, p.k * p.N) or out4.a.dtype != torch.int32 \
            or not (torch.equal(out4.a, out4b.a)
                    and torch.equal(out4.b, out4b.b)):
        fail("L2_32 unfolded PBS: wrong shape or dtype, or calls differ")
    err4 = signed_max_abs(tlwe.phase(out4, key_out) - luts[slots])
    log(f"# L2_32 unfolded decrypt: max error "
        f"2^{math.log2(max(err4, 1.0)):.2f} (bound "
        f"2^{math.log2(UNFOLDED_BOUND_32):.0f})")
    if not err4 < UNFOLDED_BOUND_32:
        fail(f"L2_32 unfolded decrypt: max error 2^{math.log2(err4):.2f}")
    acc_in4, rot4, _ = bootstrap.unfolded_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bk4, 4), cs.a, bk4)
    G4, M4 = bk4.su.shape[0], bk4.su.shape[1]
    acc_k4 = held("unfolded_rotate",
                  lambda: pk.unfolded_rotate(acc_in4, rot4, bk4.su, kp4),
                  lambda: pk.unfolded_rotate_plain(acc_in4, rot4, bk4.su, kp4),
                  unfolded_bound(kp4, BATCH, G4, M4, max_clock))
    ext4 = trlwe.extract_tlwe(trlwe.from_stacked(acc_k4), 0)
    if not (torch.equal(ext4.a, out4.a) and torch.equal(ext4.b, out4.b)):
        fail("L2_32 unfolded PBS output != extract of K4's rotation")
    k4 = runs["unfolded_rotate"]
    k34_res = k3_k4_residency(pk, kp4, 32, M4, "L2_32")
    k4_l2 = unfolded_l2_traffic(kp4, BATCH, G4, M4, k4["ms"])
    log(f"# L2_32 unfolded PBS (u={U_PBS}, G={G4}, M={M4}): first call "
        f"{first4_s:.3f} s; warm {ub_ms:.3f} ms per batch of {BATCH} = "
        f"{BATCH / ub_ms * 1e3:.2f} boot/s; peak {ub_peak / 2**30:.2f} GiB; "
        f"K4 {k4['ms']:.3f} ms/launch, plain {k4['plain_ms']:.3f} ms, bound "
        f"{k4['bound_ms']:.3f} ms ({k4['bound_by']}); bit-exact; key "
        f"products read through L2 {k4_l2['l2_bytes']:.4g} B = "
        f"{k4_l2['l2_bytes_per_s'] / 1e12:.3f} TB/s at K4's time")
    del acc_in4, rot4, acc_k4

    # UBR at u=4: one ciphertext of m = 2/8, UBR_LUTS random 4-slot LUTs
    c1 = tlwe.encrypt(torus.double2torus(2 / 8.0, dev), key_tlwe, gen)
    lut_vals = rng.uniform_torus(gen, (UBR_LUTS, 4), dev)
    tvs = trlwe.torus_packing(lut_vals, p.k, p.N)
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = bootstrap.multivalue_bootstrap_UBR_phase1(c1, bk4)
    torch.cuda.synchronize()
    ph1_s = time.perf_counter() - t0
    counts["ubr_phase1"] = read_counts(pk)
    check_counts("L2_32 UBR phase 1", counts["ubr_phase1"],
                 {"ubr_phase1_combine": 1})
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_u = bootstrap.multivalue_bootstrap_UBR_phase2(tvs, c1, sa, bk4, 4)
    torch.cuda.synchronize()
    ph2_s = time.perf_counter() - t0
    counts["ubr_phase2"] = read_counts(pk)
    check_counts("L2_32 UBR phase 2", counts["ubr_phase2"],
                 {"ext_product_apply_scan": 1})
    if out_u.a.shape != (UBR_LUTS, p.k * p.N) or out_u.a.dtype != torch.int32:
        fail(f"L2_32 UBR output {tuple(out_u.a.shape)} {out_u.a.dtype}")
    ubr_err = signed_max_abs(tlwe.phase(out_u, key_out) - lut_vals[:, 2])
    log(f"# L2_32 UBR decrypt: max error over {UBR_LUTS} LUTs "
        f"2^{math.log2(max(ubr_err, 1.0)):.2f} (bound "
        f"2^{math.log2(UNFOLDED_BOUND_32):.0f})")
    if not ubr_err < UNFOLDED_BOUND_32:
        fail(f"L2_32 UBR decrypt: max error 2^{math.log2(ubr_err):.2f}")
    rot_u, _ = bootstrap.ubr_phase1_inputs(c1, bk4)
    sa_k = held("ubr_phase1_combine",
                lambda: pk.ubr_phase1_combine(bk4.su, rot_u, kp4),
                lambda: pk.ubr_phase1_combine_plain(bk4.su, rot_u, kp4),
                ubr_phase1_bound(kp4, 1, G4, M4, max_clock), K5_REPS,
                queued_ms)
    if not torch.equal(pk.i32_as_u32(sa_k[0]), sa.v):
        fail("L2_32 UBR phase 1 output != K5's words")
    acc_u, sa32, per_row, _ = bootstrap.ubr_phase2_inputs(tvs, c1, sa, bk4, 4)
    acc_k3 = held("ext_product_apply_scan",
                  lambda: pk.ext_product_apply_scan(acc_u, sa32, kp4, per_row),
                  lambda: pk.ext_product_apply_scan_plain(acc_u, sa32, kp4,
                                                          per_row),
                  apply_scan_bound(kp4, UBR_LUTS, G4, per_row, max_clock))
    ext_u = trlwe.extract_tlwe(trlwe.from_stacked(acc_k3), 0)
    if not (torch.equal(ext_u.a, out_u.a) and torch.equal(ext_u.b, out_u.b)):
        fail("L2_32 UBR phase 2 output != extract of K3's products")
    k5, k3 = runs["ubr_phase1_combine"], runs["ext_product_apply_scan"]
    log(f"# L2_32 UBR (u={U_PBS}, G={G4}, M={M4}): phase 1 first call "
        f"{ph1_s * 1e3:.3f} ms, K5 {k5['ms']:.3f} ms/launch (plain "
        f"{k5['plain_ms']:.3f}, bound {k5['bound_ms']:.4f} {k5['bound_by']});"
        f" phase 2 of {UBR_LUTS} LUTs first call {ph2_s * 1e3:.3f} ms, K3 "
        f"{k3['ms']:.3f} ms/launch = {k3['ms'] / UBR_LUTS:.4f} ms per LUT "
        f"(plain {k3['plain_ms']:.3f}, bound {k3['bound_ms']:.4f} "
        f"{k3['bound_by']}); bit-exact")
    ubr_steps, ubr_counts, ubr_runs = ubr_steps_phase(
        bk4, c1, tvs, sa, out_u, k5["ms"], k3["ms"], max_clock)
    counts.update(ubr_counts)
    runs.update(ubr_runs)
    del sa, sa_k, sa32, acc_u, acc_k3, rot_u
    k5_batch, counts[f"ubr_phase1_b{K5_BATCH}"] = k5_batch_phase(
        bk4, first_cts(cs, K5_BATCH), max_clock, "L2_32")
    k5.update({"resident_blocks_per_sm":
                   k5_batch["schedule"][1]["blocks_per_sm"],
               f"batch{K5_BATCH}": {key: k5_batch[key] for key in (
                   "k5_ms", "bound_ms", "bound_by", "phase1_warm_ms",
                   "schedule")}})

    # trgsw.external_product on BATCH TRLWEs: one TRGSW broadcast, one per
    # row
    m_ep = rng.uniform_torus(gen, (BATCH, p.N), dev)
    c_ep = trlwe.encrypt(m_ep, key_trlwe, gen)
    e_ep = (torch.arange(BATCH, device=dev) * 7) % (2 * p.N)
    g_all = trgsw.to_dft(trgsw.monomial_encrypt(
        torch.ones(BATCH, dtype=torch.int64, device=dev), e_ep, gk, gen),
        gk.plan(), with_shoup=False)
    g_one = trgsw.TRGSWDFT(v=g_all.v[5], vs=None, l=p.l, Bg_bit=p.Bg_bit,
                           primes=g_all.primes)
    ep = {}
    for mode, g, e in (("broadcast", g_one, e_ep[5]),
                       ("per_row", g_all, e_ep)):
        zero_counts(pk)
        out_ep = trgsw.external_product(c_ep, g)
        torch.cuda.synchronize()
        counts[f"extprod_{mode}"] = read_counts(pk)
        check_counts(f"L2_32 external product ({mode})",
                     counts[f"extprod_{mode}"], {"ext_product_apply_scan": 1})
        zero_counts(pk)
        with plain_kernels(pk):
            plain_ep_ms, out_p = cuda_ms(
                lambda: trgsw.external_product(c_ep, g), 1)
        check_counts(f"plain L2_32 external product ({mode})",
                     read_counts(pk), {"ext_product_apply_scan_plain": 1})
        if out_ep.b.dtype != torch.int32 or not (
                torch.equal(out_ep.a, out_p.a)
                and torch.equal(out_ep.b, out_p.b)):
            fail(f"L2_32 external product ({mode}) != plain")
        want = trlwe.mul_by_xai(trlwe.noiseless_trivial(m_ep, p.k, p.N), e).b
        ep_err = signed_max_abs(trlwe.phase(out_ep, key_trlwe) - want)
        if not ep_err < DECRYPT_BOUND_32:
            fail(f"L2_32 external product ({mode}) decrypt: max error "
                 f"2^{math.log2(ep_err):.2f} >= 2^26")
        ep_ms, _ = cuda_ms(lambda: trgsw.external_product(c_ep, g), REPS)
        ep[mode] = {"ms": ep_ms, "plain_ms": plain_ep_ms,
                    "k3_ms": k3_alone_ms(pk, c_ep, g, kp4, mode == "per_row"),
                    "launches": counts[f"extprod_{mode}"][
                        "ext_product_apply_scan"],
                    "decrypt_max_err_log2": math.log2(max(ep_err, 1.0)),
                    "bound": apply_scan_bound(kp4, BATCH, 1,
                                              mode == "per_row", max_clock)}
        log(f"# L2_32 external_product ({mode}) on {BATCH} TRLWEs: "
            f"{ep_ms:.3f} ms per call (K3 alone {ep[mode]['k3_ms']:.4f} ms), "
            f"plain {plain_ep_ms:.3f} ms, bound "
            f"{ep[mode]['bound']['bound_ms']:.4f} ms; 1 K3 launch; bit-exact;"
            f" decrypt OK (max err 2^{ep[mode]['decrypt_max_err_log2']:.2f})")
    del g_all, g_one, c_ep, m_ep, out_ep, out_p
    return {"counts": counts, "kernel_runs": runs, "bk4": bk4, "out4": out4,
            "unfolded": {"unfolding": U_PBS, "keygen_s": keygen4_s,
                         "key_bytes": su4_bytes, "first_call_s": first4_s,
                         "warm_ms": ub_ms, "boot_per_s": BATCH / ub_ms * 1e3,
                         "peak_bytes": ub_peak,
                         "decrypt_max_err_log2": math.log2(max(err4, 1.0)),
                         "glue_ms": ub_ms - k4["ms"],
                         "k3_k4_residency": k34_res,
                         "k4_l2_traffic": k4_l2},
            "ubr": {"unfolding": U_PBS, "luts": UBR_LUTS,
                    "phase1_first_ms": ph1_s * 1e3, "phase1_ms": k5["ms"],
                    "phase2_first_ms": ph2_s * 1e3, "phase2_ms": k3["ms"],
                    "phase2_ms_per_lut": k3["ms"] / UBR_LUTS,
                    "decrypt_max_err_log2": math.log2(max(ubr_err, 1.0)),
                    "phase1_batch": k5_batch},
            "ubr_steps": ubr_steps, "extprod": ep}


def torus32_mesh(p, dev, max_clock, bk, tv, cs, out, unfolded):
    """Phase 20's sharded paths at L2_32: pbs_on_mesh on MESH_SHAPES_32
    meshes of the card through the one-limb K8a and K8b (exact counts,
    words equal to the one-limb K1 path's ``out``), K8a and K8b held to
    their plain versions on the (1, 2) mesh's first step, then
    unfolded_pbs_on_mesh at model 2 on MESH_CUT ciphertexts, equal to the
    u=4 path's words.  Takes the u=4 key and output out of ``unfolded``."""
    from mosfhet_torch import bootstrap, tlwe
    from mosfhet_torch.ops import pbs_kernel as pk
    from mosfhet_torch.parallel import mesh as pmesh

    report, counts, runs = {}, {}, {}
    for data, model in MESH_SHAPES_32:
        name = f"mesh_{data}x{model}"
        run = pmesh.pbs_on_mesh(pmesh.make_mesh([dev] * (data * model),
                                                data=data, model=model),
                                bk, 4)
        zero_counts(pk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_m = run(tv, cs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        mesh_ms, out_m2 = cuda_ms(lambda: run(tv, cs), REPS)
        counts[name] = read_counts(pk)
        calls = 1 + REPS
        check_counts(f"L2_32 {name} over {calls} calls", counts[name],
                     {"partial_step": calls * bk.n * data * model,
                      "finish_step": calls * bk.n * data})
        for o in (out_m, out_m2):
            if not (torch.equal(o.a, out.a) and torch.equal(o.b, out.b)):
                fail(f"L2_32 {name} output != the one-limb K1 path's")
        report[name] = {"data": data, "model": model,
                        "first_call_s": first_s, "warm_ms": mesh_ms,
                        "boot_per_s": BATCH / mesh_ms * 1e3,
                        "launches_per_call": {k: v // calls for k, v in
                                              counts[name].items() if v}}
        log(f"# L2_32 pbs_on_mesh ({data} x {model}): first call "
            f"{first_s:.3f} s; warm {mesh_ms:.3f} ms per batch of {BATCH} = "
            f"{BATCH / mesh_ms * 1e3:.2f} boot/s; words equal to the one-limb"
            f" K1 path's; launches per call "
            f"{report[name]['launches_per_call']}")
        del run, out_m, out_m2
    # K8a and K8b alone on the (1, 2) mesh's first step: the path's inputs
    kp = bk.kernel_plan()
    acc_in, a_int, _ = bootstrap.blind_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bk, 4), cs.a, bk)
    jl = kp.J // 2
    tp_args = [(acc_in, a_int[0].contiguous(), s * jl,
                bk.v32[0, s * jl:(s + 1) * jl].contiguous(),
                bk.vs32[0, s * jl:(s + 1) * jl].contiguous(), kp)
               for s in range(2)]
    parts = torch.empty((2, BATCH, kp.C, kp.P, kp.N), dtype=torch.int32,
                        device=dev)
    pk.partial_step(*tp_args[1], out=parts[1])
    k8a_bound = partial_step_bound(kp, BATCH, jl, max_clock)
    k8a_ms, _ = queued_ms(
        lambda: pk.partial_step(*tp_args[0], out=parts[0]), TP_REPS)
    k8a_plain_ms, part_p = cuda_ms(
        lambda: pk.partial_step_plain(*tp_args[0]), 1)
    same_or_fail("K8a/torus32 on the path's inputs (shard 0)", parts[0],
                 part_p)
    same_or_fail("K8a/torus32 on the path's inputs (shard 1)", parts[1],
                 pk.partial_step_plain(*tp_args[1]))
    acc_f = acc_in.clone()
    k8b_ms, _ = queued_ms(lambda: pk.finish_step(acc_f, parts, kp),
                          TP_REPS)
    acc_k8 = pk.finish_step(acc_in.clone(), parts, kp)
    k8b_plain_ms, acc_p8 = cuda_ms(
        lambda: pk.finish_step_plain(acc_in.clone(), parts, kp), 1)
    same_or_fail("K8b/torus32 on the path's inputs", acc_k8, acc_p8)
    one_step = pk.blind_rotate_scan(acc_in, a_int[:1].contiguous(),
                                    bk.v32[:1], bk.vs32[:1], kp)
    same_or_fail("K8a x 2 + K8b vs one K1 step at L2_32", acc_k8, one_step)
    k8b_bound = finish_step_bound(kp, BATCH, 2, max_clock)
    for name, ms, plain_ms, bound in (
            ("partial_step", k8a_ms, k8a_plain_ms, k8a_bound),
            ("finish_step", k8b_ms, k8b_plain_ms, k8b_bound)):
        runs[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
                      "bound_ms": bound["bound_ms"],
                      "bound_by": bound["bound_by"], "bound": bound}
    log(f"# L2_32 partial_step (K8a) at B={BATCH}, {jl} key rows: kernel "
        f"{k8a_ms:.4f} ms/launch (mean of {TP_REPS}), plain "
        f"{k8a_plain_ms:.3f} ms, bound {k8a_bound['bound_ms']:.4f} ms "
        f"({k8a_bound['bound_by']}); finish_step (K8b) on 2 partials: "
        f"{k8b_ms:.4f} ms/launch, plain {k8b_plain_ms:.3f} ms, bound "
        f"{k8b_bound['bound_ms']:.4f} ms ({k8b_bound['bound_by']}); "
        f"bit-exact; 2 K8a + K8b = one K1 step, word for word")
    del tp_args, parts, part_p, acc_f, acc_k8, acc_p8, one_step
    for name, r in report.items():      # every mesh here has model > 1
        r["sharded"] = sharded_share(pk, bk, kp, acc_in, a_int, r["data"],
                                     r["model"], r["warm_ms"])
        log_share("L2_32", name, r["sharded"])
    report["k8_residency"] = k8_residency(pk, kp, 32, "L2_32")
    del acc_in
    # the unfolded route at model 2 (plain PyTorch, no kernel launch)
    bk4, out4 = unfolded.pop("bk4"), unfolded.pop("out4")
    n_cut = min(MESH_CUT, BATCH)
    c_cut = tlwe.TLWE(a=cs.a[:n_cut].contiguous(),
                      b=cs.b[:n_cut].contiguous())
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pmesh.unfolded_pbs_on_mesh(
        pmesh.make_mesh([dev] * 2, data=1, model=2), bk4, 4,
        model_axis="model")(tv, c_cut)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    check_counts("L2_32 unfolded_pbs_on_mesh (1 x 2)", read_counts(pk), {})
    if not (torch.equal(got.a, out4.a[:n_cut])
            and torch.equal(got.b, out4.b[:n_cut])):
        fail("L2_32 unfolded_pbs_on_mesh (1 x 2) != the K4 path's words")
    log(f"# L2_32 unfolded_pbs_on_mesh (1 x 2, plain PyTorch) on {n_cut} "
        f"ciphertexts: {route_s:.3f} s; words equal to the K4 path's")
    report["unfolded_route"] = {"s": route_s, "ciphertexts": n_cut}
    report.update(counts=counts, kernel_runs=runs)
    return report


def torus32_ga(p, dev, max_clock, gen, gk, key_tlwe, key_trlwe, key_out,
               tv, luts, cs, slots, out):
    """Phase 20's GA family at L2_32 through the one-limb K6 and K7: the GA
    keygen (seconds, bytes, peak), functional_bootstrap_ga of the PBS's 512
    ciphertexts (1 K6 and 1 K7 launch per call, decrypt within 2^27), K6
    and K7 held to their plain versions on the path's own inputs (K7's
    plain on all 512), trlwe_keyswitch and eval_automorphism on 512 TRLWEs
    (1 K6 launch each, within trlwe_ks_bound), ga_pbs_on_mesh at (2, 1)
    (K6 + K7 per data shard) and at (1, 2) on MESH_CUT ciphertexts (the
    plain route), both equal to the bootstrap's words.  Returns the
    report, with the paths' counts and the kernels' runs."""
    from mosfhet_torch import (bootstrap, bootstrap_ga, keyswitch,
                               polynomial, rng, tlwe, trlwe)
    from mosfhet_torch.ops import pbs_kernel as pk
    from mosfhet_torch.parallel import mesh as pmesh

    runs, counts = {}, {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bkg = bootstrap_ga.new_key(gk, key_tlwe, gen, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    keygen_peak = torch.cuda.max_memory_allocated()
    key_bytes = sum(t.numel() * t.element_size()
                    for t in (bkg.s_v32, bkg.s_vs32, bkg.ak, bkg.inv2n))
    kpg, kpg_ks = bkg.kernel_plans()
    if kpg.torus_bits != 32 or kpg_ks.torus_bits != 32:
        fail("L2_32 GA plans are not 32-bit")
    log(f"# L2_32 GA keygen: {keygen_s:.3f} s; TRGSW "
        f"{tuple(bkg.s_v32.shape)} u32 x2, keyset {tuple(bkg.ak.shape)} u32 "
        f"(P_ks={kpg_ks.P}); {key_bytes} B in all; peak "
        f"{keygen_peak / 2**30:.2f} GiB; placements K6 "
        f"{placement(pk, 'auto_keyswitch_stream', kpg_ks, 'auto_keyswitch')}"
        f", K7 "
        f"{placement(pk, 'ga_scan', kpg, P_ks=kpg_ks.P)}")
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_g = bootstrap_ga.functional_bootstrap_ga(tv, cs, bkg, 4)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ga_ms, out_g2 = cuda_ms(
        lambda: bootstrap_ga.functional_bootstrap_ga(tv, cs, bkg, 4), REPS)
    counts["ga"] = read_counts(pk)
    ga_peak = torch.cuda.max_memory_allocated()
    check_counts(f"L2_32 GA path over {1 + REPS} calls", counts["ga"],
                 {"auto_keyswitch_stream": 1 + REPS,
                  "ga_scan_fused": 1 + REPS})
    if out_g.a.shape != (BATCH, p.k * p.N) or out_g.a.dtype != torch.int32 \
            or not (torch.equal(out_g.a, out_g2.a)
                    and torch.equal(out_g.b, out_g2.b)):
        fail("L2_32 GA bootstrap: wrong shape or dtype, or calls differ")
    ga_err = signed_max_abs(tlwe.phase(out_g, key_out) - luts[slots])
    log(f"# L2_32 GA decrypt: max error 2^{math.log2(max(ga_err, 1.0)):.2f}"
        f" (bound 2^{math.log2(GA_DECRYPT_BOUND_32):.0f})")
    if not ga_err < GA_DECRYPT_BOUND_32:
        fail(f"L2_32 GA decrypt: max error 2^{math.log2(ga_err):.2f}")
    acc_g, kidx0, ginv0, gens, _ = bootstrap_ga.ga_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bkg, 4), cs.a, bkg)
    acc_k6 = hold(runs, "auto_keyswitch_stream",
                  lambda: pk.auto_keyswitch_stream(acc_g, bkg.ak, kidx0,
                                                   ginv0, kpg_ks),
                  lambda: pk.auto_keyswitch_stream_plain(acc_g, bkg.ak,
                                                         kidx0, ginv0,
                                                         kpg_ks),
                  auto_ks_bound(kpg_ks, BATCH, kidx0, max_clock),
                  reps=KS_REPS)
    ga_args = (gens, bkg.s_v32, bkg.s_vs32, bkg.ak, bkg.inv2n, kpg, kpg_ks)
    acc_k7 = hold(runs, "ga_scan_fused",
                  lambda: pk.ga_scan_fused(acc_k6, *ga_args),
                  lambda: pk.ga_scan_fused_plain(acc_k6, *ga_args),
                  ga_bound(kpg, kpg_ks, gens, max_clock))
    ext_g = trlwe.extract_tlwe(trlwe.from_stacked(acc_k7), 0)
    if not (torch.equal(ext_g.a, out_g.a) and torch.equal(ext_g.b, out_g.b)):
        fail("L2_32 GA output != extract of K7's rotation")
    k6, k7 = runs["auto_keyswitch_stream"], runs["ga_scan_fused"]
    log(f"# L2_32 GA bootstrap: first call {first_s:.3f} s; warm "
        f"{ga_ms:.3f} ms per batch of {BATCH} = {BATCH / ga_ms * 1e3:.2f} "
        f"boot/s; peak {ga_peak / 2**30:.2f} GiB; K6 {k6['ms']:.4f} "
        f"ms/launch (mean of {KS_REPS}), plain {k6['plain_ms']:.3f}, bound "
        f"{k6['bound_ms']:.4f} ({k6['bound_by']}); K7 {k7['ms']:.3f} "
        f"ms/launch, plain {k7['plain_ms']:.3f} on all {BATCH} ciphertexts, "
        f"bound {k7['bound_ms']:.3f} ({k7['bound_by']}: "
        f"{k7['bound']['int32_ops']:.4g} int32 ops); glue "
        f"{ga_ms - k6['ms'] - k7['ms']:.3f} ms; bit-exact")
    k7_res = k7_residency(pk, kpg, kpg_ks, 32)
    k7_curve = wave_curve(
        lambda acc, g: pk.ga_scan_fused(acc, g, *ga_args[1:]), acc_k6, gens,
        k7_res["resident_ciphertexts"])
    log_wave_curve("L2_32", "K7", k7_res, k7_curve)
    k6_res = k6_residency(pk, kpg_ks, 32, "L2_32")
    del acc_g, acc_k6, acc_k7, out_g2

    # the TRLWE key switch and eval_automorphism on BATCH TRLWEs
    key_in = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    ksk_r = keyswitch.new_trlwe_ks_key(key_trlwe, key_in, p.l, p.Bg_bit, gen,
                                       dev)
    gen_auto = 2 * p.N - 3
    ksk_auto = keyswitch.new_automorphism_ks_keyset(
        key_trlwe, [gen_auto], p.l, p.Bg_bit, gen, dev)[gen_auto]
    m_ks = rng.uniform_torus(gen, (BATCH, p.N), dev)
    rks_bound = trlwe_ks_bound(p, p.l, p.Bg_bit, 32)
    ks = {}
    for name, c_in, fn, want in (
            ("trlwe_keyswitch", trlwe.encrypt(m_ks, key_in, gen),
             lambda c: keyswitch.trlwe_keyswitch(c, ksk_r), m_ks),
            ("eval_automorphism", trlwe.encrypt(m_ks, key_trlwe, gen),
             lambda c: keyswitch.eval_automorphism(c, gen_auto, ksk_auto),
             polynomial.permute(m_ks, gen_auto))):
        zero_counts(pk)
        out_ks = fn(c_in)
        torch.cuda.synchronize()
        counts[name] = read_counts(pk)
        check_counts(f"L2_32 {name}", counts[name],
                     {"auto_keyswitch_stream": 1})
        zero_counts(pk)
        with plain_kernels(pk):
            plain_ks_ms, out_p = cuda_ms(lambda: fn(c_in), 1)
        check_counts(f"plain L2_32 {name}", read_counts(pk),
                     {"auto_keyswitch_stream_plain": 1})
        if out_ks.b.dtype != torch.int32 or not (
                torch.equal(out_ks.a, out_p.a)
                and torch.equal(out_ks.b, out_p.b)):
            fail(f"L2_32 {name} != plain")
        ks_e = signed_max_abs(trlwe.phase(out_ks, key_trlwe) - want)
        if not ks_e <= rks_bound:
            fail(f"L2_32 {name} decrypt: max error 2^{math.log2(ks_e):.2f} "
                 f"> 2^{math.log2(rks_bound):.0f}")
        ks_ms, _ = cuda_ms(lambda: fn(c_in), REPS)
        ks[name] = {"ms": ks_ms, "plain_ms": plain_ks_ms, "launches": 1,
                    "decrypt_max_err_log2": math.log2(max(ks_e, 1.0)),
                    "decrypt_bound_log2": math.log2(rks_bound)}
        log(f"# L2_32 {name} on {BATCH} TRLWEs: {ks_ms:.3f} ms per call, "
            f"plain {plain_ks_ms:.3f} ms; 1 K6 launch; bit-exact; decrypt OK "
            f"(max err 2^{ks[name]['decrypt_max_err_log2']:.2f} against "
            f"2^{math.log2(rks_bound):.0f})")
    ks["eval_automorphism"]["gen"] = gen_auto
    del ksk_r, ksk_auto, m_ks, out_ks, out_p

    # ga_pbs_on_mesh: model 1 through K6 + K7, model 2 the plain route
    mesh = {}
    run = pmesh.ga_pbs_on_mesh(pmesh.make_mesh([dev] * 2, data=2, model=1),
                               bkg, 4)
    zero_counts(pk)
    got = run(tv, cs)
    torch.cuda.synchronize()
    counts["ga_mesh_2x1"] = read_counts(pk)
    check_counts("L2_32 ga_pbs_on_mesh (2 x 1)", counts["ga_mesh_2x1"],
                 {"auto_keyswitch_stream": 2, "ga_scan_fused": 2})
    if not (torch.equal(got.a, out_g.a) and torch.equal(got.b, out_g.b)):
        fail("L2_32 ga_pbs_on_mesh (2 x 1) != the GA bootstrap's words")
    mesh_ms, _ = cuda_ms(lambda: run(tv, cs), REPS)
    mesh["2x1"] = {"warm_ms": mesh_ms, "boot_per_s": BATCH / mesh_ms * 1e3}
    n_cut = min(MESH_CUT, BATCH)
    c_cut = tlwe.TLWE(a=cs.a[:n_cut].contiguous(),
                      b=cs.b[:n_cut].contiguous())
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pmesh.ga_pbs_on_mesh(pmesh.make_mesh([dev] * 2, data=1, model=2),
                               bkg, 4, model_axis="model")(tv, c_cut)
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    check_counts("L2_32 ga_pbs_on_mesh (1 x 2)", read_counts(pk), {})
    if not (torch.equal(got.a, out_g.a[:n_cut])
            and torch.equal(got.b, out_g.b[:n_cut])):
        fail("L2_32 ga_pbs_on_mesh (1 x 2) != the GA bootstrap's words")
    mesh["1x2_plain"] = {"s": route_s, "ciphertexts": n_cut}
    log(f"# L2_32 ga_pbs_on_mesh (2 x 1): 2 K6 + 2 K7 launches per call, "
        f"warm {mesh_ms:.3f} ms per batch of {BATCH} = "
        f"{BATCH / mesh_ms * 1e3:.2f} boot/s; (1 x 2, plain PyTorch) on "
        f"{n_cut} ciphertexts: {route_s:.3f} s; words equal to the GA "
        f"bootstrap's")
    del bkg, run, got, out_g
    return {"counts": counts, "kernel_runs": runs,
            "ga": {"keygen_s": keygen_s, "key_bytes": key_bytes,
                   "keygen_peak_bytes": keygen_peak, "P_ks": kpg_ks.P,
                   "first_call_s": first_s, "warm_ms": ga_ms,
                   "boot_per_s": BATCH / ga_ms * 1e3, "peak_bytes": ga_peak,
                   "decrypt_max_err_log2": math.log2(max(ga_err, 1.0)),
                   "decrypt_bound_log2": math.log2(GA_DECRYPT_BOUND_32),
                   "glue_ms": ga_ms - k6["ms"] - k7["ms"], "mesh": mesh,
                   "k6_residency": k6_res, "k7_residency": k7_res,
                   "k7_wave_curve": k7_curve},
            "trlweks": {"t": p.l, "base_bit": p.Bg_bit, **ks}}


def main():
    t_start = time.perf_counter()
    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mosfhet_torch import (bootstrap, ntt, params, rng, tlwe, torus,
                               trgsw, trlwe)
    from mosfhet_torch.ops import _build, pbs_kernel as pk

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    max_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"# card: {card}; max SM clock {max_clock} MHz; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    # 2. build
    build_s = _build.build()
    log(f"# build: {build_s:.1f} s for {sorted(_build.build_log)}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")
    k1_build = k1_ptxas(_build.build_log["blind_rotate"])
    k7_build = k7_ptxas(_build.build_log["ga_scan"])
    k8_build = k8_ptxas(_build.build_log["tp_step"])
    k3_build = sched_ptxas(_build.build_log["ext_product_apply"],
                           "ext_product_apply", "K3")
    k4_build = sched_ptxas(_build.build_log["unfolded_rotate"],
                           "unfolded_rotate", "K4")
    k1d_build = sched_ptxas(_build.build_log["cmux_delta"], "cmux_delta",
                            "K1-delta")
    k6_build = sched_ptxas(_build.build_log["auto_keyswitch"],
                           "auto_keyswitch", "K6")
    k2_k5_build = k2_k5_ptxas(_build.build_log["tlwe_keyswitch"],
                              _build.build_log["ubr_phase1"])
    log_build(k1_build + k7_build + k8_build + k3_build + k4_build
              + k1d_build + k6_build + k2_k5_build)

    # 3. kernel vs plain at full width on random inputs
    p = params.TFHEPP_L2
    primes = ntt.primes_for_bound(
        ntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    kp = pk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, dev)
    n_short, b_short = 8, 4
    rs = np.random.default_rng(SEED)
    acc0 = torch.from_numpy(rs.integers(
        0, 1 << 64, (b_short, kp.C, p.N), dtype=np.uint64).view(np.int64)).to(dev)
    a_np = rs.integers(0, 2 * p.N + 1, (n_short, b_short), dtype=np.int32)
    a_np[0, 0], a_np[1, 1], a_np[-1, -1] = 0, 2 * p.N, p.N
    a_short = torch.from_numpy(a_np).to(dev)
    pr = np.array(primes, np.uint64)[:, None]
    kv = rs.integers(0, 1 << 62, (n_short, kp.J, kp.C, kp.P, p.N),
                     dtype=np.uint64) % pr
    kvs = (kv << np.uint64(32)) // pr
    kv32 = torch.from_numpy(kv.astype(np.uint32).view(np.int32)).to(dev)
    kvs32 = torch.from_numpy(kvs.astype(np.uint32).view(np.int32)).to(dev)
    got = pk.blind_rotate_scan(acc0, a_short, kv32, kvs32, kp)
    torch.cuda.synchronize()
    want = pk.blind_rotate_scan_plain(acc0, a_short, kv32, kvs32, kp)
    if not torch.equal(got, want):
        fail(f"kernel != plain at L2 widths, n={n_short}, B={b_short}: "
             f"{int((got != want).sum())} words differ")
    log(f"# kernel vs plain, L2 widths, n={n_short}, B={b_short}: bit-exact")

    # 4. main path
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    key_tlwe = tlwe.new_binary_key(p.n, p.lwe_sigma, gen, dev)
    key_trlwe = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    gk = trgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = bootstrap.new_key(gk, key_tlwe, gen, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_bytes = (bk.v32.numel() + bk.vs32.numel()) * 4
    log(f"# keygen: {keygen_s:.3f} s; key {tuple(bk.v32.shape)} u32 x2 = "
        f"{key_bytes / 2**20:.1f} MiB")
    luts = rng.uniform_torus(gen, (4,), dev)
    tv = trlwe.torus_packing(luts, p.k, p.N)
    slots = torch.arange(BATCH, device=dev) % 4
    cs = tlwe.encrypt(torus.double2torus(slots.to(torch.float64) / 8.0),
                      key_tlwe, gen)

    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bootstrap.functional_bootstrap(tv, cs, bk, 4)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pbs_ms, out2 = cuda_ms(
        lambda: bootstrap.functional_bootstrap(tv, cs, bk, 4), REPS)
    pbs_counts = read_counts(pk)
    launches = pbs_counts["blind_rotate_scan"]
    peak = torch.cuda.max_memory_allocated()
    check_counts(f"main path over {1 + REPS} calls", pbs_counts,
                 {"blind_rotate_scan": 1 + REPS})
    if out.a.shape != (BATCH, p.k * p.N) or out.b.shape != (BATCH,):
        fail(f"output shapes {tuple(out.a.shape)}, {tuple(out.b.shape)}")
    if not (torch.equal(out.a, out2.a) and torch.equal(out.b, out2.b)):
        fail("repeated bootstraps of the same inputs differ")
    err = signed_max_abs(tlwe.phase(out, key_out) - luts[slots])
    if not err <= DECRYPT_BOUND:
        fail(f"decrypt: max error 2^{math.log2(err):.1f} > 2^58")
    log(f"# main path: first call {first_s:.3f} s; warm {pbs_ms:.3f} ms per "
        f"batch of {BATCH} = {BATCH / pbs_ms * 1e3:.2f} boot/s; decrypt OK "
        f"(max err 2^{math.log2(max(err, 1.0)):.1f}); peak "
        f"{peak / 2**30:.2f} GiB; blind_rotate_scan launches {launches}")

    # 5. the kernel and the plain version on the main path's own inputs
    acc_in, a_int, _ = bootstrap.blind_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bk, 4), cs.a, bk)
    bkp = bk.kernel_plan()
    kernel_ms, acc_k = cuda_ms(
        lambda: pk.blind_rotate_scan(acc_in, a_int, bk.v32, bk.vs32, bkp),
        REPS)
    plain_ms, acc_p = cuda_ms(
        lambda: pk.blind_rotate_scan_plain(acc_in, a_int, bk.v32, bk.vs32,
                                           bkp), 1)
    max_abs_err = signed_max_abs(acc_k - acc_p)
    if max_abs_err != 0.0:
        fail(f"kernel != plain on the main path's inputs "
             f"({int((acc_k != acc_p).sum())} words)")
    ext = trlwe.extract_tlwe(trlwe.from_stacked(acc_k), 0)
    if not (torch.equal(ext.a, out.a) and torch.equal(ext.b, out.b)):
        fail("main path output != extract of the kernel's rotation")
    plain2_ms, acc_p2 = cuda_ms(
        lambda: pk.blind_rotate_scan_plain(acc_in[:2].contiguous(),
                                           a_int[:, :2].contiguous(),
                                           bk.v32, bk.vs32, bkp), 1)
    if not torch.equal(acc_p2, acc_k[:2]):
        fail("plain rotation of the first 2 ciphertexts != kernel")
    bound = rotation_bound_ms(bkp, bk.n, BATCH, key_bytes, max_clock)
    log(f"# blind_rotate_scan at B={BATCH}, n={bk.n}: kernel {kernel_ms:.3f} "
        f"ms/launch, plain {plain_ms:.3f} ms (first 2 ciphertexts: "
        f"{plain2_ms:.3f} ms), bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}: {bound['multiplies']:.4g} int32 multiplies at "
        f"{bound['int32_per_s']:.4g}/s, {bound['bytes']:.4g} B at "
        f"{HBM_BYTES_PER_S:.3g} B/s); bit-exact")
    k1_res = k1_residency(pk, bkp, 64)
    k1_curve = wave_curve(
        lambda acc, a: pk.blind_rotate_scan(acc, a, bk.v32, bk.vs32, bkp),
        acc_in, a_int, k1_res["K1"]["resident_ciphertexts"])
    log_wave_curve("L2", "K1", k1_res["K1"], k1_curve,
                   f"; K1-step {k1_res['K1-step']['blocks_per_sm']}")

    # 4b. the per-step rotation (K1-step) on phase 4's key, LUT and
    #     ciphertexts, held to phase 5's K1 output
    steps, steps_counts, steps_runs = rotation_steps_phase(
        bk, tv, cs, acc_k, kernel_ms, max_clock)

    # 6. the key-switch kernel vs plain at full L2 widths, random inputs
    n_in, n_out, base_m1 = p.k * p.N, p.n, (1 << p.base_bit) - 1
    b_short = 4
    dig_np = rs.integers(0, base_m1 + 1, (b_short, n_in, p.t), dtype=np.int32)
    dig_np[0, 0, 0], dig_np[-1, -1, -1] = 0, base_m1
    ab_rand = torch.from_numpy(rs.integers(
        0, 1 << 64, (n_in, p.t, base_m1, n_out + 1),
        dtype=np.uint64).view(np.int64)).to(dev)
    d = torch.from_numpy(dig_np).to(dev)
    got = pk.tlwe_keyswitch_sum(d, ab_rand)
    torch.cuda.synchronize()
    want = pk.tlwe_keyswitch_sum_plain(d, ab_rand)
    if not torch.equal(got, want):
        fail(f"ks kernel != plain at L2 widths: "
             f"{int((got != want).sum())} words differ")
    del ab_rand
    log(f"# ks kernel vs plain, L2 widths, B={b_short}: bit-exact")

    # 7. gate: the port's own L2 key-switch key, then phase 4's outputs
    #    switched back to the LWE key
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ksk = tlwe.new_ks_key(key_tlwe, key_out, p.t, p.base_bit, gen, dev)
    torch.cuda.synchronize()
    ks_keygen_s = time.perf_counter() - t0
    ks_key_bytes = ksk.ab.numel() * 8
    log(f"# ks keygen: {ks_keygen_s:.3f} s; table {tuple(ksk.ab.shape)} "
        f"int64 = {ks_key_bytes} B")
    zero_counts(pk)
    ks_out = tlwe.keyswitch(out, ksk)
    torch.cuda.synchronize()
    gate_counts = read_counts(pk)
    check_counts("gate", gate_counts, {"tlwe_keyswitch_sum": 1})
    ks_err = signed_max_abs(tlwe.phase(ks_out, key_tlwe) - luts[slots])
    if not ks_err <= KS_DECRYPT_BOUND:
        fail(f"gate decrypt: max error 2^{math.log2(ks_err):.1f} > 2^60")
    dig = tlwe.keyswitch_inputs(out, ksk)
    ks_run, sub_k = k2_report(pk, "L2 gate", dig, ksk.ab, max_clock)
    ks_ms = ks_run["ms"]
    ks_plain_ms, sub_p = cuda_ms(
        lambda: pk.tlwe_keyswitch_sum_plain(dig, ksk.ab), 1)
    ks_max_abs_err = signed_max_abs(sub_k - sub_p)
    if ks_max_abs_err != 0.0:
        fail(f"ks kernel != plain on the gate's inputs "
             f"({int((sub_k != sub_p).sum())} words)")
    if not (torch.equal(ks_out.a, -sub_k[:, :n_out])
            and torch.equal(ks_out.b, out.b - sub_k[:, n_out])):
        fail("gate output != (0, b) minus the kernel's select-sum")
    ks_bound = ks_run["bound"]
    log(f"# tlwe_keyswitch_sum at B={BATCH}: kernel {ks_ms:.3f} ms/launch "
        f"(one launch, then the mean of {KS_REPS}), plain "
        f"{ks_plain_ms:.3f} ms, bound "
        f"{ks_bound['bound_ms']:.3f} ms ({ks_bound['bound_by']}: "
        f"{ks_bound['int32_ops']:.4g} int32 ops at "
        f"{ks_bound['int32_per_s']:.4g}/s, {ks_bound['bytes']:.4g} B at "
        f"{HBM_BYTES_PER_S:.3g} B/s); bit-exact; decrypt OK (max err "
        f"2^{math.log2(max(ks_err, 1.0)):.1f})")
    del dig, sub_k, sub_p

    # 8. fdfb_this_work main path
    luts8 = rng.uniform_torus(gen, (8,), dev)
    tv8 = trlwe.torus_packing_many_lut(luts8, 4, 2, p.k, p.N)
    m8 = torch.arange(BATCH, device=dev) % 8
    c8 = tlwe.encrypt(torus.int2torus(m8, FDFB_PREC), key_tlwe, gen)
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out8 = bootstrap.fdfb_this_work(tv8, c8, bk, ksk, FDFB_PREC)
    torch.cuda.synchronize()
    fdfb_first_s = time.perf_counter() - t0
    fdfb_ms, out8b = cuda_ms(
        lambda: bootstrap.fdfb_this_work(tv8, c8, bk, ksk, FDFB_PREC), REPS)
    fdfb_counts = read_counts(pk)
    fdfb_peak = torch.cuda.max_memory_allocated()
    calls = 1 + REPS
    check_counts(f"fdfb path over {calls} calls", fdfb_counts,
                 {"blind_rotate_scan": 2 * calls, "tlwe_keyswitch_sum": calls})
    if out8.a.shape != (BATCH, p.k * p.N) or out8.b.shape != (BATCH,):
        fail(f"fdfb output shapes {tuple(out8.a.shape)}, "
             f"{tuple(out8.b.shape)}")
    if not (torch.equal(out8.a, out8b.a) and torch.equal(out8.b, out8b.b)):
        fail("repeated fdfb calls on the same inputs differ")
    fdfb_err = signed_max_abs(tlwe.phase(out8, key_out) - luts8[m8])
    if not fdfb_err <= DECRYPT_BOUND:
        fail(f"fdfb decrypt: max error 2^{math.log2(fdfb_err):.1f} > 2^58")
    c2 = tlwe.TLWE(a=c8.a[:2].contiguous(), b=c8.b[:2].contiguous())
    zero_counts(pk)
    with plain_kernels(pk):
        fdfb_plain2_ms, out_p = cuda_ms(
            lambda: bootstrap.fdfb_this_work(tv8, c2, bk, ksk, FDFB_PREC), 1)
    plain_counts = read_counts(pk)
    check_counts("plain fdfb", plain_counts,
                 {"blind_rotate_scan_plain": 2, "tlwe_keyswitch_sum_plain": 1})
    if not (torch.equal(out_p.a, out8.a[:2]) and torch.equal(out_p.b,
                                                             out8.b[:2])):
        fail("plain fdfb of the first 2 ciphertexts != the kernel path")
    glue_ms = fdfb_ms - 2 * kernel_ms - ks_ms
    log(f"# fdfb_this_work: first call {fdfb_first_s:.3f} s; warm "
        f"{fdfb_ms:.3f} ms per batch of {BATCH} = "
        f"{BATCH / fdfb_ms * 1e3:.2f} fdfb/s (2 x rotation {kernel_ms:.3f} + "
        f"key switch {ks_ms:.3f} + glue {glue_ms:.3f} ms); decrypt OK (max "
        f"err 2^{math.log2(max(fdfb_err, 1.0)):.1f}); peak "
        f"{fdfb_peak / 2**30:.2f} GiB; counts {fdfb_counts}; plain whole "
        f"call on 2 ciphertexts {fdfb_plain2_ms:.3f} ms, bit-exact")
    dig = fdfb_ks_digits(bootstrap, tlwe, trlwe, torus, c8, bk, ksk,
                         FDFB_PREC)
    ks_fdfb, sub_k = k2_report(pk, "L2 fdfb", dig, ksk.ab, max_clock)
    same_or_fail("K2 vs plain on the fdfb's key-switch inputs", sub_k,
                 pk.tlwe_keyswitch_sum_plain(dig, ksk.ab))
    del dig, sub_k

    # 9. K3, K4, K5 vs plain at full L2 widths on random inputs
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    for per_row in (False, True):
        B_r, G_r = 5, 2
        acc_r = random_u64(rs, (B_r, C, N), dev)
        rows = (G_r, B_r) if per_row else (G_r,)
        sa_r = random_residues_i32(rs, rows + (J, C, P, N), primes, dev)
        got = pk.ext_product_apply_scan(acc_r, sa_r, kp, per_row)
        torch.cuda.synchronize()
        same_or_fail(f"K3 (per_row={per_row}) vs plain at L2 widths", got,
                     pk.ext_product_apply_scan_plain(acc_r, sa_r, kp, per_row))
    for u, G_r in ((2, 2), (4, 2), (8, 1)):
        B_r, M = 3, 1 << u
        acc_r = random_u64(rs, (B_r, C, N), dev)
        su_r = random_u64(rs, (G_r, M, J, C, N), dev)
        rot_r = random_exponents(rs, B_r, G_r, M, N, dev)
        got = pk.unfolded_rotate(acc_r, rot_r, su_r, kp)
        torch.cuda.synchronize()
        same_or_fail(f"K4 (u={u}) vs plain at L2 widths", got,
                     pk.unfolded_rotate_plain(acc_r, rot_r, su_r, kp))
        got = pk.ubr_phase1_combine(su_r, rot_r, kp)
        torch.cuda.synchronize()
        same_or_fail(f"K5 (u={u}) vs plain at L2 widths", got,
                     pk.ubr_phase1_combine_plain(su_r, rot_r, kp))
        got = pk.ubr_phase1_combine_v1(su_r, rot_r, kp)
        torch.cuda.synchronize()
        same_or_fail(f"K5-v1 (u={u}) vs plain at L2 widths", got,
                     pk.ubr_phase1_combine_v1_plain(su_r, rot_r, kp))
    # the one-step kernels: K1-step on phase 3's first key rows, K3-step
    B_r = 5
    acc_r = random_u64(rs, (B_r, C, N), dev)
    a_np = rs.integers(0, 2 * N + 1, B_r, dtype=np.int32)
    a_np[:3] = [0, N, 2 * N]
    a_r = torch.from_numpy(a_np).to(dev)
    got = pk.pbs_step(acc_r.clone(), a_r, kv32[0], kvs32[0], kp)
    torch.cuda.synchronize()
    same_or_fail("K1-step vs plain at L2 widths", got,
                 pk.pbs_step_plain(acc_r.clone(), a_r, kv32[0], kvs32[0], kp))
    for per_row in (False, True):
        key_r = random_residues_i32(
            rs, ((B_r,) if per_row else ()) + (J, C, P, N), primes, dev)
        got = pk.ext_product_apply_step(acc_r.clone(), key_r, kp, per_row)
        torch.cuda.synchronize()
        same_or_fail(f"K3-step (per_row={per_row}) vs plain at L2 widths",
                     got, pk.ext_product_apply_step_plain(acc_r.clone(), key_r,
                                                          kp, per_row))
    # K5 and K5-v1 at the batch shapes (`k5_batches`), u=4, G=2: L2 widths
    # with u64 words, L2_32 widths with u32 words
    # (L2_32's 2 primes: this process's torus is 64 bits wide)
    kp_32 = pk.get_kernel_plan(N, ntt.MASTER_PRIMES[-2:], L2_32["l"],
                               L2_32["Bg_bit"], 1, dev, 32)
    batches = {}
    for kp_r in (kp, kp_32):
        bits = kp_r.torus_bits
        su_r = (random_u64 if bits == 64 else random_u32)(
            rs, (2, 16, kp_r.J, C, N), dev)
        batches[bits] = k5_batches(pk, N, bits)
        for B_r in batches[bits]:
            rot_r = random_exponents(rs, B_r, 2, 16, N, dev)
            want = pk.ubr_phase1_combine_plain(su_r, rot_r, kp_r)
            for name in ("ubr_phase1_combine", "ubr_phase1_combine_v1"):
                got = getattr(pk, name)(su_r, rot_r, kp_r)
                torch.cuda.synchronize()
                same_or_fail(f"{name} (u=4, B={B_r}, u{bits} words) vs "
                             "plain", got, want)
    del acc_r, su_r, rot_r, sa_r, got, key_r, want
    log("# K3 (broadcast and per-row, G=2, B=5), K4, K5 and K5-v1 (u=2, 4, "
        "8; exponents 0, N, 2N), K1-step (B=5; exponents 0, N, 2N) and "
        "K3-step (broadcast and per-row) vs plain at L2 widths; K5 and K5-v1 "
        f"also at u=4, B = {', '.join(map(str, batches[64]))} (L2 widths) "
        f"and B = {', '.join(map(str, batches[32]))} (L2_32 widths, u32 "
        "words): bit-exact")

    # 10. the unfolded PBS at u=4 on phase 4's LUT and ciphertexts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bk4 = bootstrap.new_key(gk, key_tlwe, gen, dev, unfolding=U_PBS)
    torch.cuda.synchronize()
    keygen4_s = time.perf_counter() - t0
    su4_bytes = bk4.su.numel() * bk4.su.element_size()
    log(f"# unfolded keygen (u={U_PBS}): {keygen4_s:.3f} s; key "
        f"{tuple(bk4.su.shape)} u64 = {su4_bytes} B")
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out4 = bootstrap.functional_bootstrap(tv, cs, bk4, 4)
    torch.cuda.synchronize()
    first4_s = time.perf_counter() - t0
    ub_ms, out4b = cuda_ms(
        lambda: bootstrap.functional_bootstrap(tv, cs, bk4, 4), REPS)
    ub_counts = read_counts(pk)
    ub_peak = torch.cuda.max_memory_allocated()
    check_counts(f"unfolded path over {1 + REPS} calls", ub_counts,
                 {"unfolded_rotate": 1 + REPS})
    if out4.a.shape != (BATCH, p.k * p.N) or out4.b.shape != (BATCH,):
        fail(f"unfolded output shapes {tuple(out4.a.shape)}, "
             f"{tuple(out4.b.shape)}")
    if not (torch.equal(out4.a, out4b.a) and torch.equal(out4.b, out4b.b)):
        fail("repeated unfolded bootstraps of the same inputs differ")
    err4 = signed_max_abs(tlwe.phase(out4, key_out) - luts[slots])
    if not err4 <= DECRYPT_BOUND:
        fail(f"unfolded decrypt: max error 2^{math.log2(err4):.1f} > 2^58")
    acc_in4, rot4, _ = bootstrap.unfolded_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bk4, 4), cs.a, bk4)
    kp4 = bk4.kernel_plan()
    k4_ms, acc_k4 = cuda_ms(
        lambda: pk.unfolded_rotate(acc_in4, rot4, bk4.su, kp4), REPS)
    k4_plain_ms, acc_p4 = cuda_ms(
        lambda: pk.unfolded_rotate_plain(acc_in4, rot4, bk4.su, kp4), 1)
    k4_err = signed_max_abs(acc_k4 - acc_p4)
    if k4_err != 0.0:
        fail(f"K4 != plain on the unfolded path's inputs "
             f"({int((acc_k4 != acc_p4).sum())} words)")
    ext4 = trlwe.extract_tlwe(trlwe.from_stacked(acc_k4), 0)
    if not (torch.equal(ext4.a, out4.a) and torch.equal(ext4.b, out4.b)):
        fail("unfolded path output != extract of K4's rotation")
    G4, M4 = bk4.su.shape[0], bk4.su.shape[1]
    k4_bound = unfolded_bound(kp4, BATCH, G4, M4, max_clock)
    k34_res = k3_k4_residency(pk, kp4, 64, M4, "L2")
    k4_l2 = unfolded_l2_traffic(kp4, BATCH, G4, M4, k4_ms)
    log(f"# unfolded PBS (u={U_PBS}): first call {first4_s:.3f} s; warm "
        f"{ub_ms:.3f} ms per batch of {BATCH} = {BATCH / ub_ms * 1e3:.2f} "
        f"boot/s (u=1: {BATCH / pbs_ms * 1e3:.2f}); decrypt OK (max err "
        f"2^{math.log2(max(err4, 1.0)):.1f}); peak {ub_peak / 2**30:.2f} GiB")
    log(f"# unfolded_rotate at B={BATCH}, G={G4}, M={M4}: kernel "
        f"{k4_ms:.3f} ms/launch, plain {k4_plain_ms:.3f} ms on the same "
        f"inputs, bound {k4_bound['bound_ms']:.3f} ms ({k4_bound['bound_by']}"
        f": {k4_bound['int32_ops']:.4g} int32 ops, {k4_bound['bytes']:.4g} "
        f"B); bit-exact; key products read through L2 "
        f"{k4_l2['l2_bytes']:.4g} B = {k4_l2['l2_bytes_per_s'] / 1e12:.3f} "
        f"TB/s at K4's time")
    del acc_in4, rot4, acc_k4, acc_p4          # bk4 and out4: phase 18

    # 11. UBR at u=8: one ciphertext, 256 LUTs
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bk8 = bootstrap.new_key(gk, key_tlwe, gen, dev, unfolding=U_UBR)
    torch.cuda.synchronize()
    keygen8_s = time.perf_counter() - t0
    su8_bytes = bk8.su.numel() * bk8.su.element_size()
    keygen8_peak = torch.cuda.max_memory_allocated()
    log(f"# unfolded keygen (u={U_UBR}): {keygen8_s:.3f} s; key "
        f"{tuple(bk8.su.shape)} u64 = {su8_bytes} B; peak "
        f"{keygen8_peak / 2**30:.2f} GiB")
    c1 = tlwe.encrypt(torus.double2torus(2 / 8.0, dev), key_tlwe, gen)
    lut_vals = rng.uniform_torus(gen, (UBR_LUTS, 4), dev)
    tvs = trlwe.torus_packing(lut_vals, p.k, p.N)
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = bootstrap.multivalue_bootstrap_UBR_phase1(c1, bk8)
    torch.cuda.synchronize()
    ph1_s = time.perf_counter() - t0
    ph1_counts = read_counts(pk)
    check_counts("UBR phase 1", ph1_counts, {"ubr_phase1_combine": 1})
    zero_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_u = bootstrap.multivalue_bootstrap_UBR_phase2(tvs, c1, sa, bk8, 4)
    torch.cuda.synchronize()
    ph2_s = time.perf_counter() - t0
    ph2_counts = read_counts(pk)
    ubr_peak = torch.cuda.max_memory_allocated()
    check_counts("UBR phase 2", ph2_counts, {"ext_product_apply_scan": 1})
    if out_u.a.shape != (UBR_LUTS, p.k * p.N):
        fail(f"UBR output shape {tuple(out_u.a.shape)}")
    ubr_err = signed_max_abs(tlwe.phase(out_u, key_out) - lut_vals[:, 2])
    if not ubr_err <= DECRYPT_BOUND:
        fail(f"UBR decrypt: max error 2^{math.log2(ubr_err):.1f} > 2^58")
    kp8 = bk8.kernel_plan()
    rot8, _ = bootstrap.ubr_phase1_inputs(c1, bk8)
    k5_ms, sa_k = k5_time(pk.ubr_phase1_combine, bk8.su, rot8, kp8)
    k5_plain_ms, sa_p = cuda_ms(
        lambda: pk.ubr_phase1_combine_plain(bk8.su, rot8, kp8), 1)
    k5_err = signed_max_abs(pk.i32_as_u32(sa_k) - pk.i32_as_u32(sa_p))
    if k5_err != 0.0:
        fail(f"K5 != plain on the UBR inputs ({int((sa_k != sa_p).sum())} "
             f"words)")
    if not torch.equal(pk.i32_as_u32(sa_k[0]), sa.v):
        fail("UBR phase 1 output != K5's words")
    acc_u, sa32, per_row, _ = bootstrap.ubr_phase2_inputs(tvs, c1, sa, bk8, 4)
    k3_ms, acc_k3 = cuda_ms(
        lambda: pk.ext_product_apply_scan(acc_u, sa32, kp8, per_row), REPS)
    k3_plain_ms, acc_p3 = cuda_ms(
        lambda: pk.ext_product_apply_scan_plain(acc_u, sa32, kp8, per_row), 1)
    k3_err = signed_max_abs(acc_k3 - acc_p3)
    if k3_err != 0.0:
        fail(f"K3 != plain on the UBR phase-2 inputs "
             f"({int((acc_k3 != acc_p3).sum())} words)")
    ext_u = trlwe.extract_tlwe(trlwe.from_stacked(acc_k3), 0)
    if not (torch.equal(ext_u.a, out_u.a) and torch.equal(ext_u.b, out_u.b)):
        fail("UBR phase 2 output != extract of K3's products")
    G8, M8 = bk8.su.shape[0], bk8.su.shape[1]
    k5_bound = ubr_phase1_bound(kp8, 1, G8, M8, max_clock)
    k3_bound = apply_scan_bound(kp8, UBR_LUTS, G8, per_row, max_clock)
    log(f"# UBR (u={U_UBR}, G={G8}, M={M8}): phase 1 first call "
        f"{ph1_s * 1e3:.3f} ms, K5 {k5_ms:.3f} ms/launch (plain "
        f"{k5_plain_ms:.3f} ms, bound {k5_bound['bound_ms']:.3f} ms "
        f"{k5_bound['bound_by']}); phase 2 of {UBR_LUTS} LUTs first call "
        f"{ph2_s * 1e3:.3f} ms, K3 {k3_ms:.3f} ms/launch = "
        f"{k3_ms / UBR_LUTS:.4f} ms per LUT (plain {k3_plain_ms:.3f} ms, "
        f"bound {k3_bound['bound_ms']:.3f} ms {k3_bound['bound_by']}); "
        f"bit-exact; decrypt OK (max err 2^{math.log2(max(ubr_err, 1.0)):.1f}"
        f"); peak {ubr_peak / 2**30:.2f} GiB")

    del sa_k, sa_p, sa32, acc_u, acc_k3, acc_p3
    k5_batch, k5_batch_counts = k5_batch_phase(
        bk8, first_cts(cs, K5_BATCH), max_clock, "L2")
    k5_batch["build"] = [e for e in k2_k5_build if e["entry"] == "K5"]

    # 11b. UBR phase 1 through K5-v1, phase 2 one cached group per launch
    #      (K3-step), on phase 11's key, ciphertext, LUTs and cache
    ubr_steps, ubr_steps_counts, ubr_steps_runs = ubr_steps_phase(
        bk8, c1, tvs, sa, out_u, k5_ms, k3_ms, max_clock)
    del bk8, sa, rot8

    # 12. trgsw.external_product at L2 on 512 TRLWEs, both modes
    m_ep = rng.uniform_torus(gen, (BATCH, p.N), dev)
    c_ep = trlwe.encrypt(m_ep, key_trlwe, gen)
    e_ep = (torch.arange(BATCH, device=dev) * 7) % (2 * p.N)
    g_all = trgsw.to_dft(trgsw.monomial_encrypt(
        torch.ones(BATCH, dtype=torch.int64, device=dev), e_ep, gk, gen),
        gk.plan(), with_shoup=False)
    g_one = trgsw.TRGSWDFT(v=g_all.v[5], vs=None, l=p.l, Bg_bit=p.Bg_bit,
                           primes=g_all.primes)
    ep = {}
    for mode, g, e in (("broadcast", g_one, e_ep[5]),
                       ("per_row", g_all, e_ep)):
        zero_counts(pk)
        out_ep = trgsw.external_product(c_ep, g)
        torch.cuda.synchronize()
        counts = read_counts(pk)
        check_counts(f"external product ({mode})", counts,
                     {"ext_product_apply_scan": 1})
        zero_counts(pk)
        with plain_kernels(pk):
            plain_ep_ms, out_p = cuda_ms(
                lambda: trgsw.external_product(c_ep, g), 1)
        check_counts(f"plain external product ({mode})", read_counts(pk),
                     {"ext_product_apply_scan_plain": 1})
        if not (torch.equal(out_ep.a, out_p.a)
                and torch.equal(out_ep.b, out_p.b)):
            fail(f"external product ({mode}) != plain")
        want = trlwe.mul_by_xai(trlwe.noiseless_trivial(m_ep, p.k, p.N), e).b
        ep_err = signed_max_abs(trlwe.phase(out_ep, key_trlwe) - want)
        if not ep_err <= DECRYPT_BOUND:
            fail(f"external product ({mode}) decrypt: max error "
                 f"2^{math.log2(ep_err):.1f} > 2^58")
        ep_ms, _ = cuda_ms(lambda: trgsw.external_product(c_ep, g), REPS)
        ep[mode] = {"ms": ep_ms, "plain_ms": plain_ep_ms,
                    "k3_ms": k3_alone_ms(pk, c_ep, g, kp, mode == "per_row"),
                    "launches": counts["ext_product_apply_scan"],
                    "decrypt_max_err_log2": math.log2(max(ep_err, 1.0)),
                    "bound": apply_scan_bound(kp, BATCH, 1,
                                              mode == "per_row", max_clock)}
        log(f"# external_product ({mode}) on {BATCH} TRLWEs: {ep_ms:.3f} ms "
            f"per call (K3 alone {ep[mode]['k3_ms']:.4f} ms), plain "
            f"{plain_ep_ms:.3f} ms, bound "
            f"{ep[mode]['bound']['bound_ms']:.3f} ms; 1 K3 launch; "
            f"bit-exact; decrypt OK (max err "
            f"2^{ep[mode]['decrypt_max_err_log2']:.1f})")
    del g_all, g_one, c_ep, m_ep, out_ep, out_p

    # 13. K6 and K7 vs plain at full L2 widths on random inputs
    from mosfhet_torch import bootstrap_ga, keyswitch, polynomial
    kp_ks = pk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, dev)
    G_full, Jk = p.N, p.k * p.l
    ak_r = random_residues_i32(rs, (G_full, Jk, C, P, N), primes, dev)
    inv2n = torch.from_numpy(bootstrap_ga.inverse_mod_2n_table(N)).to(dev)
    B_r = 64
    x_r = random_u64(rs, (B_r, C, N), dev)
    kidx_np = rs.integers(0, G_full, B_r, dtype=np.int32)
    kidx_np[0], kidx_np[-1] = 0, G_full - 1
    ginv_np = rs.integers(0, N, B_r, dtype=np.int32) * 2 + 1
    ginv_np[0], ginv_np[1] = 1, 2 * N - 1
    kidx_r, ginv_r = (torch.from_numpy(v).to(dev) for v in (kidx_np, ginv_np))
    got = pk.auto_keyswitch_stream(x_r, ak_r, kidx_r, ginv_r, kp_ks)
    torch.cuda.synchronize()
    same_or_fail("K6 vs plain at L2 widths", got,
                 pk.auto_keyswitch_stream_plain(x_r, ak_r, kidx_r, ginv_r,
                                                kp_ks))
    n_r, B_r = 4, 8
    acc_r = random_u64(rs, (B_r, C, N), dev)
    sv_r = random_residues_i32(rs, (n_r, J, C, P, N), primes, dev)
    pr_t = torch.tensor(primes, dtype=torch.int64, device=dev)[:, None]
    svs_r = pk.u32_as_i32((pk.i32_as_u32(sv_r) << 32) // pr_t)
    gens_np = rs.integers(0, N, (n_r, B_r), dtype=np.int32) * 2 + 1
    gens_np[0, 0], gens_np[-1, -1] = 1, 2 * N - 1
    gens_r = torch.from_numpy(gens_np).to(dev)
    got = pk.ga_scan_fused(acc_r, gens_r, sv_r, svs_r, ak_r, inv2n, kp, kp_ks)
    torch.cuda.synchronize()
    same_or_fail("K7 vs plain at L2 widths", got,
                 pk.ga_scan_fused_plain(acc_r, gens_r, sv_r, svs_r, ak_r,
                                        inv2n, kp, kp_ks))
    del ak_r, x_r, acc_r, sv_r, svs_r, got
    log("# K6 (B=64, full random keyset; ginv 1, 2N-1; kidx 0, N-1) and K7 "
        "(n=4, B=8; generators 1, 2N-1) vs plain at L2 widths: bit-exact")

    # 14. the GA bootstrap on phase 4's LUT and ciphertexts
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bkg = bootstrap_ga.new_key(gk, key_tlwe, gen, dev)
    torch.cuda.synchronize()
    ga_keygen_s = time.perf_counter() - t0
    ga_keygen_peak = torch.cuda.max_memory_allocated()
    ga_key_bytes = sum(t.numel() * t.element_size()
                       for t in (bkg.s_v32, bkg.s_vs32, bkg.ak, bkg.inv2n))
    log(f"# GA keygen: {ga_keygen_s:.3f} s; TRGSW {tuple(bkg.s_v32.shape)} "
        f"u32 x2, keyset {tuple(bkg.ak.shape)} u32; {ga_key_bytes} B in all; "
        f"peak {ga_keygen_peak / 2**30:.2f} GiB")
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_g = bootstrap_ga.functional_bootstrap_ga(tv, cs, bkg, 4)
    torch.cuda.synchronize()
    ga_first_s = time.perf_counter() - t0
    ga_ms, out_g2 = cuda_ms(
        lambda: bootstrap_ga.functional_bootstrap_ga(tv, cs, bkg, 4), REPS)
    ga_counts = read_counts(pk)
    ga_peak = torch.cuda.max_memory_allocated()
    check_counts(f"GA path over {1 + REPS} calls", ga_counts,
                 {"auto_keyswitch_stream": 1 + REPS,
                  "ga_scan_fused": 1 + REPS})
    if out_g.a.shape != (BATCH, p.k * p.N) or out_g.b.shape != (BATCH,):
        fail(f"GA output shapes {tuple(out_g.a.shape)}, "
             f"{tuple(out_g.b.shape)}")
    if not (torch.equal(out_g.a, out_g2.a) and torch.equal(out_g.b, out_g2.b)):
        fail("repeated GA bootstraps of the same inputs differ")
    ga_err = signed_max_abs(tlwe.phase(out_g, key_out) - luts[slots])
    if not ga_err <= DECRYPT_BOUND:
        fail(f"GA decrypt: max error 2^{math.log2(ga_err):.1f} > 2^58")
    acc_g, kidx0, ginv0, gens, _ = bootstrap_ga.ga_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bkg, 4), cs.a, bkg)
    kpg, kpg_ks = bkg.kernel_plans()
    k6_ms, acc_k6 = cuda_ms(lambda: pk.auto_keyswitch_stream(
        acc_g, bkg.ak, kidx0, ginv0, kpg_ks), KS_REPS)
    k6_plain_ms, acc_p6 = cuda_ms(lambda: pk.auto_keyswitch_stream_plain(
        acc_g, bkg.ak, kidx0, ginv0, kpg_ks), 1)
    k6_err = signed_max_abs(acc_k6 - acc_p6)
    if k6_err != 0.0:
        fail(f"K6 != plain on the GA path's inputs "
             f"({int((acc_k6 != acc_p6).sum())} words)")
    ga_args = (gens, bkg.s_v32, bkg.s_vs32, bkg.ak, bkg.inv2n, kpg, kpg_ks)
    k7_ms, acc_k7 = cuda_ms(lambda: pk.ga_scan_fused(acc_k6, *ga_args), REPS)
    k7_plain_ms, acc_p7 = cuda_ms(
        lambda: pk.ga_scan_fused_plain(acc_k6, *ga_args), 1)
    k7_err = signed_max_abs(acc_k7 - acc_p7)
    if k7_err != 0.0:
        fail(f"K7 != plain on the GA path's inputs "
             f"({int((acc_k7 != acc_p7).sum())} words)")
    # the same launch with every generator 1: every block reads keyset
    # entry 0, which stays in L2, against the path's random entries
    k7_entry0_ms, _ = cuda_ms(lambda: pk.ga_scan_fused(
        acc_k6, torch.ones_like(gens), *ga_args[1:]), 1)
    ext_g = trlwe.extract_tlwe(trlwe.from_stacked(acc_k7), 0)
    if not (torch.equal(ext_g.a, out_g.a) and torch.equal(ext_g.b, out_g.b)):
        fail("GA path output != extract of K7's rotation")
    k6_bound = auto_ks_bound(kpg_ks, BATCH, kidx0, max_clock)
    k7_bound = ga_bound(kpg, kpg_ks, gens, max_clock)
    log(f"# GA bootstrap: first call {ga_first_s:.3f} s; warm {ga_ms:.3f} ms "
        f"per batch of {BATCH} = {BATCH / ga_ms * 1e3:.2f} boot/s (PBS u=1: "
        f"{BATCH / pbs_ms * 1e3:.2f}); decrypt OK (max err "
        f"2^{math.log2(max(ga_err, 1.0)):.1f}); peak {ga_peak / 2**30:.2f} GiB")
    log(f"# auto_keyswitch_stream at B={BATCH}: kernel {k6_ms:.3f} ms/launch "
        f"(mean of {KS_REPS}), plain {k6_plain_ms:.3f} ms, bound "
        f"{k6_bound['bound_ms']:.4f} ms ({k6_bound['bound_by']}: "
        f"{k6_bound['int32_ops']:.4g} int32 ops, {k6_bound['bytes']:.4g} B); "
        f"bit-exact")
    log(f"# ga_scan_fused at B={BATCH}, n={bkg.n}: kernel {k7_ms:.3f} "
        f"ms/launch, plain {k7_plain_ms:.3f} ms, bound "
        f"{k7_bound['bound_ms']:.3f} ms ({k7_bound['bound_by']}: "
        f"{k7_bound['int32_ops']:.4g} int32 ops, {k7_bound['bytes']:.4g} B "
        f"once, {k7_bound['gathered_bytes']:.4g} B of keyset gathered); "
        f"bit-exact; every generator 1 (keyset entry 0 only): "
        f"{k7_entry0_ms:.3f} ms")
    k7_res = k7_residency(pk, kpg, kpg_ks, 64)
    k7_curve = wave_curve(
        lambda acc, g: pk.ga_scan_fused(acc, g, *ga_args[1:]), acc_k6, gens,
        k7_res["resident_ciphertexts"])
    log_wave_curve("L2", "K7", k7_res, k7_curve)
    k6_res = k6_residency(pk, kpg_ks, 64, "L2")

    # 14b. the per-step GA forms (K1-delta, K6, K6-old) against K7's words
    step_report, step_counts, step_runs = ga_stepwise_phase(
        bkg, tv, cs, acc_k6, acc_k7, gens, k7_ms, max_clock)
    del acc_g, acc_k6, acc_p6, acc_k7, acc_p7

    # 15. the TRLWE key switch and eval_automorphism on 512 TRLWEs
    key_in = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    ksk_r = keyswitch.new_trlwe_ks_key(key_trlwe, key_in, p.l, p.Bg_bit, gen,
                                       dev)
    gen_auto = int(rs.integers(0, p.N)) * 2 + 1
    ksk_auto = keyswitch.new_automorphism_ks_keyset(
        key_trlwe, [gen_auto], p.l, p.Bg_bit, gen, dev)[gen_auto]
    m_ks = rng.uniform_torus(gen, (BATCH, p.N), dev)
    rks_bound = trlwe_ks_bound(p, p.l, p.Bg_bit)
    ks_cases = {
        "trlwe_keyswitch": (trlwe.encrypt(m_ks, key_in, gen),
                            lambda c: keyswitch.trlwe_keyswitch(c, ksk_r),
                            m_ks),
        "eval_automorphism": (trlwe.encrypt(m_ks, key_trlwe, gen),
                              lambda c: keyswitch.eval_automorphism(
                                  c, gen_auto, ksk_auto),
                              polynomial.permute(m_ks, gen_auto))}
    trlwe_ks = {}
    for name, (c_in, fn, want) in ks_cases.items():
        zero_counts(pk)
        out_ks = fn(c_in)
        torch.cuda.synchronize()
        counts = read_counts(pk)
        check_counts(name, counts, {"auto_keyswitch_stream": 1})
        zero_counts(pk)
        with plain_kernels(pk):
            plain_ks_ms, out_p = cuda_ms(lambda: fn(c_in), 1)
        check_counts(f"plain {name}", read_counts(pk),
                     {"auto_keyswitch_stream_plain": 1})
        if not (torch.equal(out_ks.a, out_p.a)
                and torch.equal(out_ks.b, out_p.b)):
            fail(f"{name} != plain")
        ks_e = signed_max_abs(trlwe.phase(out_ks, key_trlwe) - want)
        if not ks_e <= rks_bound:
            fail(f"{name} decrypt: max error 2^{math.log2(ks_e):.1f} > "
                 f"2^{math.log2(rks_bound):.0f}")
        ks_call_ms, _ = cuda_ms(lambda: fn(c_in), REPS)
        trlwe_ks[name] = {
            "ms": ks_call_ms, "plain_ms": plain_ks_ms,
            "launches": counts["auto_keyswitch_stream"],
            "decrypt_max_err_log2": math.log2(max(ks_e, 1.0)),
            "decrypt_bound_log2": math.log2(rks_bound)}
        log(f"# {name} on {BATCH} TRLWEs: {ks_call_ms:.3f} ms per call, "
            f"plain {plain_ks_ms:.3f} ms; 1 K6 launch; bit-exact; decrypt OK "
            f"(max err 2^{trlwe_ks[name]['decrypt_max_err_log2']:.1f} "
            f"against 2^{math.log2(rks_bound):.0f})")
    trlwe_ks["eval_automorphism"]["gen"] = gen_auto
    del ksk_auto, m_ks, ks_cases, out_ks, out_p    # ksk_r, key_in: phase 25

    # 16. K8a and K8b vs plain at full L2 widths on random inputs
    B_r = 5
    acc_r = random_u64(rs, (B_r, C, N), dev)
    a_np = rs.integers(0, 2 * N + 1, B_r, dtype=np.int32)
    a_np[:3] = 0, N, 2 * N
    a_r = torch.from_numpy(a_np).to(dev)
    for j0, jl in ((0, J // 2), (J // 2, J // 2), (3 * J // 4, J // 4)):
        kv_r = random_residues_i32(rs, (jl, C, P, N), primes, dev)
        kvs_r = pk.u32_as_i32((pk.i32_as_u32(kv_r) << 32) // pr_t)
        got = pk.partial_step(acc_r, a_r, j0, kv_r, kvs_r, kp)
        torch.cuda.synchronize()
        same_or_fail(f"K8a (rows [{j0}, {j0 + jl})) vs plain at L2 widths",
                     got, pk.partial_step_plain(acc_r, a_r, j0, kv_r, kvs_r,
                                                kp))
    for m_r in (2, 8):
        parts_r = random_residues_i32(rs, (m_r, B_r, C, P, N), primes, dev)
        parts_r[:, 0, 0, :, 0] = pk.u32_as_i32(pr_t[:, 0] - 1)
        got = pk.finish_step(acc_r.clone(), parts_r, kp)
        torch.cuda.synchronize()
        same_or_fail(f"K8b ({m_r} partials) vs plain at L2 widths", got,
                     pk.finish_step_plain(acc_r.clone(), parts_r, kp))
    del acc_r, a_r, kv_r, kvs_r, parts_r, got
    log(f"# K8a (rows [0, {J // 2}), [{J // 2}, {J}), [{3 * J // 4}, {J}); "
        f"B={B_r}; exponents 0, N, 2N) and K8b (2 and 8 partials) vs plain "
        "at L2 widths: bit-exact")

    # 17. pbs_on_mesh on meshes of the one card
    from mosfhet_torch.parallel import mesh as pmesh
    mesh_runs, mesh_counts = {}, {}
    for data, model in MESH_SHAPES:
        name = f"mesh_{data}x{model}"
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = pmesh.pbs_on_mesh(pmesh.make_mesh([dev] * (data * model),
                                                data=data, model=model),
                                bk, 4)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        zero_counts(pk)
        t0 = time.perf_counter()
        out_m = run(tv, cs)
        torch.cuda.synchronize()
        mesh_first_s = time.perf_counter() - t0
        mesh_ms, out_m2 = cuda_ms(lambda: run(tv, cs), REPS)
        counts = read_counts(pk)
        mesh_peak = torch.cuda.max_memory_allocated()
        calls = 1 + REPS
        check_counts(f"{name} over {calls} calls", counts,
                     {"partial_step": calls * bk.n * data * model,
                      "finish_step": calls * bk.n * data} if model > 1
                     else {"blind_rotate_scan": calls * data})
        for o in (out_m, out_m2):
            if not (torch.equal(o.a, out.a) and torch.equal(o.b, out.b)):
                fail(f"{name} output != phase 4's functional_bootstrap")
        m_err = signed_max_abs(tlwe.phase(out_m, key_out) - luts[slots])
        if not m_err <= DECRYPT_BOUND:
            fail(f"{name} decrypt: max error 2^{math.log2(m_err):.1f} > 2^58")
        mesh_counts[name] = counts
        mesh_runs[name] = {
            "data": data, "model": model, "setup_s": setup_s,
            "first_call_s": mesh_first_s, "warm_ms": mesh_ms,
            "boot_per_s": BATCH / mesh_ms * 1e3, "peak_bytes": mesh_peak,
            "decrypt_max_err_log2": math.log2(max(m_err, 1.0)),
            "launches_per_call": {k: v // calls for k, v in counts.items()
                                  if v}}
        log(f"# pbs_on_mesh ({data} x {model}): key slices {setup_s:.3f} s; "
            f"first call {mesh_first_s:.3f} s; warm {mesh_ms:.3f} ms per "
            f"batch of {BATCH} = {BATCH / mesh_ms * 1e3:.2f} boot/s (K1 "
            f"alone: {BATCH / pbs_ms * 1e3:.2f}); words equal to phase 4's; "
            f"decrypt OK (max err 2^{math.log2(max(m_err, 1.0)):.1f}); peak "
            f"{mesh_peak / 2**30:.2f} GiB; launches per call "
            f"{mesh_runs[name]['launches_per_call']}")
        del run, out_m, out_m2
    # K8a and K8b alone on the (1, 2) mesh's first step: the path's inputs
    jl2 = J // 2
    tp_args = [(acc_in, a_int[0].contiguous(), s * jl2,
                bk.v32[0, s * jl2:(s + 1) * jl2].contiguous(),
                bk.vs32[0, s * jl2:(s + 1) * jl2].contiguous(), bkp)
               for s in range(2)]
    parts_k = torch.empty((2, BATCH, C, P, N), dtype=torch.int32, device=dev)
    k8a_ms, _ = queued_ms(lambda: pk.partial_step(*tp_args[0],
                                                  out=parts_k[0]), TP_REPS)
    pk.partial_step(*tp_args[1], out=parts_k[1])
    k8a_plain_ms, part_p = cuda_ms(lambda: pk.partial_step_plain(
        *tp_args[0]), 1)
    k8a_err = signed_max_abs(pk.i32_as_u32(parts_k[0])
                             - pk.i32_as_u32(part_p))
    same_or_fail("K8a on the path's inputs (shard 1)", parts_k[1],
                 pk.partial_step_plain(*tp_args[1]))
    if k8a_err != 0.0:
        fail("K8a != plain on the path's inputs (shard 0)")
    acc_f = acc_in.clone()
    k8b_ms, _ = queued_ms(lambda: pk.finish_step(acc_f, parts_k, bkp),
                          TP_REPS)
    acc_k8 = pk.finish_step(acc_in.clone(), parts_k, bkp)
    k8b_plain_ms, acc_p8 = cuda_ms(
        lambda: pk.finish_step_plain(acc_in.clone(), parts_k, bkp), 1)
    k8b_err = signed_max_abs(acc_k8 - acc_p8)
    if k8b_err != 0.0:
        fail("K8b != plain on the path's inputs")
    one_step = pk.blind_rotate_scan(acc_in, a_int[:1].contiguous(),
                                    bk.v32[:1], bk.vs32[:1], bkp)
    same_or_fail("K8a x 2 + K8b vs one K1 step", acc_k8, one_step)
    k8a_bound = partial_step_bound(bkp, BATCH, jl2, max_clock)
    k8b_bound = finish_step_bound(bkp, BATCH, 2, max_clock)
    log(f"# partial_step (K8a) at B={BATCH}, {jl2} key rows: kernel "
        f"{k8a_ms:.4f} ms/launch (mean of {TP_REPS}), plain "
        f"{k8a_plain_ms:.3f} ms, bound {k8a_bound['bound_ms']:.4f} ms "
        f"({k8a_bound['bound_by']}: {k8a_bound['int32_ops']:.4g} int32 ops, "
        f"{k8a_bound['bytes']:.4g} B); finish_step (K8b) on 2 partials: "
        f"kernel {k8b_ms:.4f} ms/launch, plain {k8b_plain_ms:.3f} ms, bound "
        f"{k8b_bound['bound_ms']:.4f} ms ({k8b_bound['bound_by']}: "
        f"{k8b_bound['int32_ops']:.4g} int32 ops, {k8b_bound['bytes']:.4g} "
        f"B); bit-exact; 2 K8a + K8b = one K1 step, word for word")
    del tp_args, parts_k, part_p, acc_f, acc_k8, acc_p8, one_step
    # K8a's and K8b's residency, each sharded path's device share and the
    # wrappers' host time
    k8_res = k8_residency(pk, bkp, 64, "L2")
    for name, r in mesh_runs.items():
        if r["model"] > 1:
            r["sharded"] = sharded_share(pk, bk, bkp, acc_in, a_int,
                                         r["data"], r["model"], r["warm_ms"])
            log_share("L2", name, r["sharded"])

    # 18. the plain-PyTorch mesh routes (model 2) on the first ciphertexts
    n_cut = min(MESH_CUT, BATCH)
    c_cut = tlwe.TLWE(a=cs.a[:n_cut].contiguous(),
                      b=cs.b[:n_cut].contiguous())
    mesh12 = pmesh.make_mesh([dev] * 2, data=1, model=2)
    plain_routes = {}
    for name, fn, key, want in (
            ("unfolded", pmesh.unfolded_pbs_on_mesh, bk4, out4),
            ("ga", pmesh.ga_pbs_on_mesh, bkg, out_g)):
        zero_counts(pk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_m = fn(mesh12, key, 4, model_axis="model")(tv, c_cut)
        torch.cuda.synchronize()
        route_s = time.perf_counter() - t0
        check_counts(f"{name}_pbs_on_mesh (1 x 2)", read_counts(pk), {})
        if not (torch.equal(got_m.a, want.a[:n_cut])
                and torch.equal(got_m.b, want.b[:n_cut])):
            fail(f"{name}_pbs_on_mesh (1 x 2) != the single-device kernel "
                 f"path's words")
        plain_routes[name] = {"s": route_s, "ciphertexts": n_cut}
        log(f"# {name}_pbs_on_mesh (1 x 2, plain PyTorch) on {n_cut} "
            f"ciphertexts: {route_s:.3f} s; words equal to the "
            f"single-device kernel path's")
    del bk4, out4, got_m, c_cut

    # 19. SET_3, with buffers beyond shared memory
    set3, k1_set3, set3_runs = set3_phase(dev, max_clock)

    # 19b. K8b at N=8192 with 4 primes, one pass per component
    k8b_n8192 = n8192_phase(dev, max_clock)

    # 20. the 32-bit torus, in a child interpreter
    t32 = torus32_phase()

    # 21. the TRGSW matrix ops trgsw_mul and trgsw_reg_sub on phase 4's key
    matrix, matrix_counts = trgsw_matrix_phase(p, gk, gen, dev, max_clock,
                                               "L2")

    # 22. the key-switch family: priv_ks and tlwe_mul on phase 4's key
    ksf, ksf_counts, ksf_runs, ksf_keys = ks_family_phase(
        p, key_trlwe, gk, gen, dev, max_clock)

    # 23. the rest of bootstrap on phase 4's keys and phase 22's tables
    fam, fam_counts, fam_runs = boot_family_phase(
        p, key_tlwe, key_trlwe, gk, bk, tv, luts, gen, dev, max_clock,
        ksf_keys)

    # 24. the applications: ufhe at UFHE_SET0, the leveled LUT at L2
    apps, apps_counts, apps_runs, ufhe_keep = apps_phase(
        p, gk, key_trlwe, gen, dev, max_clock)

    # 25. keysets through io: the container, the reference's layouts and
    #     files, ufhe's keyset IO
    io_rep, io_counts, io_held = io_phase(
        p, key_tlwe, key_trlwe, gk, bk, ksk, tv, cs, luts, slots, ksk_r,
        key_in, ufhe_keep, gen, dev, max_clock)
    del ufhe_keep, ksk_r
    torch.cuda.empty_cache()

    # 26. report
    paths = {"pbs": pbs_counts, "gate": gate_counts, "fdfb": fdfb_counts,
             "unfolded": ub_counts, "ubr_phase1": ph1_counts,
             f"ubr_phase1_b{K5_BATCH}": k5_batch_counts,
             "ubr_phase2": ph2_counts, "ga": ga_counts}
    paths.update({name: {"auto_keyswitch_stream": c["launches"]}
                  for name, c in trlwe_ks.items()})
    paths.update({f"ga_{form}": c for form, c in step_counts.items()})
    paths.update(mesh_counts)
    paths.update({f"extprod_{mode}": {"ext_product_apply_scan":
                                      ep[mode]["launches"]} for mode in ep})
    paths.update({"steps": steps_counts, **ubr_steps_counts,
                  "trgsw_matrix": matrix_counts, **ksf_counts})
    paths.update({f"family_{name}": c for name, c in fam_counts.items()})
    paths.update(apps_counts)
    paths.update(io_counts)

    def by_path(name):
        return {path: c.get(name, 0) for path, c in paths.items()}

    kernels = [{
        "name": "blind_rotate_scan", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/blind_rotate.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1404",
        "launches": fdfb_counts["blind_rotate_scan"],
        "launches_by_path": by_path("blind_rotate_scan"),
        "max_abs_err": max_abs_err, "bit_exact": True,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "resident_blocks_per_sm": k1_res["K1"]["blocks_per_sm"],
        "trgsw_rows": fam_runs["blind_rotate_scan/trgsw_rows"],
        "ufhe_set0": apps_runs["blind_rotate_scan/ufhe_set0"],
        "io_paths_held": io_held["blind_rotate_scan"],
    }, {
        **k2_entry("tlwe_keyswitch_sum", fdfb_counts["tlwe_keyswitch_sum"],
                   by_path("tlwe_keyswitch_sum"), ks_run, ks_fdfb,
                   ks_plain_ms, None, KS_LIBRARY_NOTE),
        "max_abs_err": ks_max_abs_err,
        "packing_rows": ksf_runs["tlwe_keyswitch_sum"],
        "priv_sk_rows": fam_runs["tlwe_keyswitch_sum/priv_sk"],
        "ufhe_set0": {tag: apps_runs[f"tlwe_keyswitch_sum/ufhe_{tag}"]
                      for tag in ("ks", "lut_packing")},
        "io_paths_held": io_held["tlwe_keyswitch_sum"],
    }, {
        "name": "ext_product_apply_scan", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/ext_product_apply.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1944",
        "launches": ph2_counts["ext_product_apply_scan"],
        "launches_by_path": by_path("ext_product_apply_scan"),
        "max_abs_err": k3_err, "bit_exact": True,
        "ms": k3_ms, "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound["bound_ms"], "bound_by": k3_bound["bound_by"],
        "library_ms": None, "library_note": RUNTIME_KEY_LIBRARY_NOTE,
        "resident_blocks_per_sm": k34_res["K3"]["blocks_per_sm"],
    }, {
        "name": "unfolded_rotate", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/unfolded_rotate.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:3123",
        "launches": ub_counts["unfolded_rotate"],
        "launches_by_path": by_path("unfolded_rotate"),
        "max_abs_err": k4_err, "bit_exact": True,
        "ms": k4_ms, "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound["bound_ms"], "bound_by": k4_bound["bound_by"],
        "library_ms": None, "library_note": RUNTIME_KEY_LIBRARY_NOTE,
        "resident_blocks_per_sm": k34_res["K4"]["blocks_per_sm"],
        "io_paths_held": io_held["unfolded_rotate"],
    }, {
        "name": "ubr_phase1_combine", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/ubr_phase1.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:2881",
        "launches": ph1_counts["ubr_phase1_combine"],
        "launches_by_path": by_path("ubr_phase1_combine"),
        "max_abs_err": k5_err, "bit_exact": True,
        "ms": k5_ms, "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound["bound_ms"], "bound_by": k5_bound["bound_by"],
        "library_ms": None, "library_note": RUNTIME_KEY_LIBRARY_NOTE,
        "resident_blocks_per_sm": k5_batch["schedule"][1]["blocks_per_sm"],
        f"batch{K5_BATCH}": {key: k5_batch[key] for key in (
            "k5_ms", "bound_ms", "bound_by", "phase1_warm_ms", "schedule")},
    }, {
        "name": "auto_keyswitch_stream", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/auto_keyswitch.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:2374",
        "launches": ga_counts["auto_keyswitch_stream"],
        "launches_by_path": by_path("auto_keyswitch_stream"),
        "max_abs_err": k6_err, "bit_exact": True,
        "ms": k6_ms, "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound["bound_ms"], "bound_by": k6_bound["bound_by"],
        "library_ms": None, "library_note": GA_LIBRARY_NOTE,
        "resident_blocks_per_sm": k6_res["blocks_per_sm"],
        "stepwise_first_step": step_runs["auto_keyswitch_stream"],
        "ks_family": {name.split("/")[1]: r for name, r in ksf_runs.items()
                      if name.startswith("auto_keyswitch_stream/")},
        "io_paths_held": io_held["auto_keyswitch_stream"],
    }, {
        "name": "ga_scan_fused", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/ga_scan.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:2558",
        "launches": ga_counts["ga_scan_fused"],
        "launches_by_path": by_path("ga_scan_fused"),
        "max_abs_err": k7_err, "bit_exact": True,
        "ms": k7_ms, "plain_ms": k7_plain_ms,
        "bound_ms": k7_bound["bound_ms"], "bound_by": k7_bound["bound_by"],
        "library_ms": None, "library_note": GA_LIBRARY_NOTE,
        "resident_blocks_per_sm": k7_res["blocks_per_sm"],
    }, {
        "name": "partial_step", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/tp_step.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1536",
        "launches": sum(c["partial_step"] for c in mesh_counts.values()),
        "launches_by_path": by_path("partial_step"),
        "max_abs_err": k8a_err, "bit_exact": True,
        "ms": k8a_ms, "plain_ms": k8a_plain_ms,
        "bound_ms": k8a_bound["bound_ms"], "bound_by": k8a_bound["bound_by"],
        "library_ms": None, "library_note": TP_LIBRARY_NOTE,
    }, {
        "name": "finish_step", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/tp_step.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1651",
        "launches": sum(c["finish_step"] for c in mesh_counts.values()),
        "launches_by_path": by_path("finish_step"),
        "max_abs_err": k8b_err, "bit_exact": True,
        "ms": k8b_ms, "plain_ms": k8b_plain_ms,
        "bound_ms": k8b_bound["bound_ms"], "bound_by": k8b_bound["bound_by"],
        "library_ms": None, "library_note": TP_LIBRARY_NOTE,
    }]
    for name, source, line, note in (
            ("cmux_delta", "cmux_delta.cu", 895, STEP_LIBRARY_NOTE),
            ("auto_keyswitch", "auto_keyswitch.cu", 2200, GA_LIBRARY_NOTE)):
        r = step_runs[name]
        by = {path: n for path, n in by_path(name).items() if n}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mosfhet_torch/ops/csrc/{source}",
            "replaces": f"mosfhet_tpu/ops/pbs_kernel.py:{line}",
            "launches": sum(by.values()), "launches_by_path": by,
            "max_abs_err": r["max_abs_err"], "bit_exact": True,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "library_note": note})
    kernels[-2]["resident_blocks_per_sm"] = \
        step_report["k1_delta_residency"]["blocks_per_sm"]
    kernels[-1]["resident_blocks_per_sm"] = \
        step_runs["auto_keyswitch"]["resident_blocks_per_sm"]
    kernels[-1]["placement"] = step_runs["auto_keyswitch"]["placement"]
    kernels += step_entries({**steps_runs, **ubr_steps_runs}, by_path)
    for entry in kernels:
        runs3 = {name: r for name, r in set3_runs.items()
                 if name.split("/")[0] == entry["name"]}
        if runs3:
            entry["set3"] = runs3
    kernels.append(k1_set3)
    kernels.append(k8b_n8192)
    c32 = t32["counts"]
    kernels += [{
        "name": "blind_rotate_scan/torus32", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/blind_rotate.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1404",
        "launches": c32["fdfb"]["blind_rotate_scan"],
        "launches_by_path": {f"{path}32": c["blind_rotate_scan"]
                             for path, c in c32.items()},
        "max_abs_err": 0.0, "bit_exact": True, "ms": t32["k1"]["ms"],
        "plain_ms": t32["k1"]["plain_ms"],
        "bound_ms": t32["k1"]["bound"]["bound_ms"],
        "bound_by": t32["k1"]["bound"]["bound_by"], "library_ms": None,
        "resident_blocks_per_sm":
            t32["k1"]["residency"]["K1"]["blocks_per_sm"],
    }, k2_entry("tlwe_keyswitch_sum/torus32",
                c32["fdfb"]["tlwe_keyswitch_sum"],
                {f"{path}32": c["tlwe_keyswitch_sum"]
                 for path, c in c32.items()}, t32["k2"]["gate"],
                t32["k2"]["fdfb"], t32["k2"]["plain_ms"],
                t32["k2"]["library_ms"], t32["k2"]["library_note"])]
    kernels[-1]["packing_rows"] = {
        name.split("/")[1]: r for name, r in t32["ks_family_runs"].items()
        if name.startswith("tlwe_keyswitch_sum/")}
    kernels[-1]["priv_sk_rows"] = t32["family_runs"][
        "tlwe_keyswitch_sum/priv_sk"]
    kernels[-2]["trgsw_rows"] = t32["family_runs"][
        "blind_rotate_scan/trgsw_rows"]
    # the one-limb K3-K7, K8a and K8b on their L2_32 paths
    for name, source, line, note in (
            ("ext_product_apply_scan", "ext_product_apply.cu", 1944,
             RUNTIME_KEY_LIBRARY_NOTE),
            ("unfolded_rotate", "unfolded_rotate.cu", 3123,
             RUNTIME_KEY_LIBRARY_NOTE),
            ("ubr_phase1_combine", "ubr_phase1.cu", 2881,
             RUNTIME_KEY_LIBRARY_NOTE),
            ("partial_step", "tp_step.cu", 1536, TP_LIBRARY_NOTE),
            ("finish_step", "tp_step.cu", 1651, TP_LIBRARY_NOTE),
            ("auto_keyswitch_stream", "auto_keyswitch.cu", 2374,
             GA_LIBRARY_NOTE),
            ("ga_scan_fused", "ga_scan.cu", 2558, GA_LIBRARY_NOTE)):
        r = t32["kernel_runs"][name]
        by = {f"{path}32": c[name] for path, c in c32.items() if c[name]}
        if not by:
            fail(f"{name}/torus32 was launched no time on its paths")
        kernels.append({
            "name": f"{name}/torus32", "route": "cuda",
            "source": f"mosfhet_torch/ops/csrc/{source}",
            "replaces": f"mosfhet_tpu/ops/pbs_kernel.py:{line}",
            "launches": sum(by.values()), "launches_by_path": by,
            "max_abs_err": r["max_abs_err"], "bit_exact": True,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "library_note": note})
        if name == "auto_keyswitch_stream":
            kernels[-1]["ks_family"] = {"priv_ks": t32["ks_family_runs"][
                "auto_keyswitch_stream/priv_ks"]}
        if name in ("ga_scan_fused", "auto_keyswitch_stream"):
            kernels[-1]["resident_blocks_per_sm"] = t32["ga"][
                "k7_residency" if name[0] == "g" else "k6_residency"][
                "blocks_per_sm"]
        if name in ("ext_product_apply_scan", "unfolded_rotate"):
            kernels[-1]["resident_blocks_per_sm"] = t32["unfolded"][
                "k3_k4_residency"]["K3" if name[0] == "e" else "K4"][
                "blocks_per_sm"]
        if name == "ubr_phase1_combine":
            kernels[-1].update({key: r[key] for key in (
                "resident_blocks_per_sm", f"batch{K5_BATCH}")})
    kernels += step_entries(
        t32["kernel_runs"],
        lambda name: {f"{path}32": c[name] for path, c in c32.items()},
        "/torus32")
    log(json.dumps({"pbs": {
        "params": p.name, "batch": BATCH, "keygen_s": keygen_s,
        "first_call_s": first_s, "warm_ms": pbs_ms,
        "boot_per_s": BATCH / pbs_ms * 1e3, "peak_bytes": peak,
        "decrypt_max_err_log2": math.log2(max(err, 1.0)),
        "build_s": build_s, "plain_first2_ms": plain2_ms,
        "bound": bound, "k1_ms": kernel_ms, "k1_residency": k1_res,
        "k1_wave_curve": k1_curve, "k1_build": k1_build}}))
    log(json.dumps({"gate": {
        "ks_keygen_s": ks_keygen_s, "ks_key_bytes": ks_key_bytes,
        "decrypt_max_err_log2": math.log2(max(ks_err, 1.0)),
        "bound": ks_bound}}))
    log(json.dumps({"fdfb": {
        "params": p.name, "batch": BATCH, "precision": FDFB_PREC,
        "first_call_s": fdfb_first_s, "warm_ms": fdfb_ms,
        "fdfb_per_s": BATCH / fdfb_ms * 1e3, "peak_bytes": fdfb_peak,
        "decrypt_max_err_log2": math.log2(max(fdfb_err, 1.0)),
        "rotation_ms": kernel_ms, "keyswitch_ms": ks_ms, "glue_ms": glue_ms,
        "plain_first2_ms": fdfb_plain2_ms}}))
    log(json.dumps({"unfolded": {
        "params": p.name, "unfolding": U_PBS, "batch": BATCH,
        "keygen_s": keygen4_s, "key_bytes": su4_bytes,
        "first_call_s": first4_s, "warm_ms": ub_ms,
        "boot_per_s": BATCH / ub_ms * 1e3,
        "boot_per_s_unfold1": BATCH / pbs_ms * 1e3, "peak_bytes": ub_peak,
        "decrypt_max_err_log2": math.log2(max(err4, 1.0)),
        "rotation_ms": k4_ms, "glue_ms": ub_ms - k4_ms, "bound": k4_bound,
        "k4_residency": k34_res["K4"], "k4_l2_traffic": k4_l2,
        "k4_build": k4_build}}))
    log(json.dumps({"ubr": {
        "params": p.name, "unfolding": U_UBR, "luts": UBR_LUTS,
        "keygen_s": keygen8_s, "key_bytes": su8_bytes,
        "keygen_peak_bytes": keygen8_peak, "peak_bytes": ubr_peak,
        "phase1_first_ms": ph1_s * 1e3, "phase1_ms": k5_ms,
        "phase2_first_ms": ph2_s * 1e3, "phase2_ms": k3_ms,
        "phase2_ms_per_lut": k3_ms / UBR_LUTS,
        "decrypt_max_err_log2": math.log2(max(ubr_err, 1.0)),
        "phase1_bound": k5_bound, "phase2_bound": k3_bound,
        "phase1_batch": k5_batch,
        "k3_residency": k34_res["K3"], "k3_build": k3_build}}))
    log(json.dumps({"steps": {"params": p.name, "rotation": steps,
                              "ubr": ubr_steps}}))
    log(json.dumps({"extprod": {"params": p.name, "batch": BATCH, **ep}}))
    log(json.dumps({"trgsw_matrix": {"params": p.name, **matrix}}))
    log(json.dumps({"ga": {
        "params": p.name, "batch": BATCH, "torus_base": 4,
        "keygen_s": ga_keygen_s, "key_bytes": ga_key_bytes,
        "keygen_peak_bytes": ga_keygen_peak, "first_call_s": ga_first_s,
        "warm_ms": ga_ms, "boot_per_s": BATCH / ga_ms * 1e3,
        "boot_per_s_pbs_unfold1": BATCH / pbs_ms * 1e3, "peak_bytes": ga_peak,
        "decrypt_max_err_log2": math.log2(max(ga_err, 1.0)),
        "auto_ks_ms": k6_ms, "rotation_ms": k7_ms,
        "rotation_entry0_ms": k7_entry0_ms,
        "glue_ms": ga_ms - k6_ms - k7_ms, "auto_ks_bound": k6_bound,
        "rotation_bound": k7_bound, "k7_residency": k7_res,
        "k7_wave_curve": k7_curve, "k7_build": k7_build,
        "k6_residency": k6_res, "k6_build": k6_build,
        "k1_delta_build": k1d_build,
        "per_step_forms": step_report}}))
    log(json.dumps({"trlweks": {"params": p.name, "batch": BATCH,
                                "t": p.l, "base_bit": p.Bg_bit, **trlwe_ks}}))
    log(json.dumps({"mesh": {
        "params": p.name, "batch": BATCH,
        "boot_per_s_k1": BATCH / pbs_ms * 1e3,
        **mesh_runs, "k8a_bound": k8a_bound, "k8b_bound": k8b_bound,
        "k8_residency": k8_res, "k8_build": k8_build,
        "plain_routes": plain_routes}}))
    log(json.dumps({"set3": set3}))
    log(json.dumps({"ks_family": {"params": p.name, "batch": BATCH, **ksf}}))
    log(json.dumps({"boot_family": {"params": p.name, "batch": BATCH,
                                    **fam}}))
    log(json.dumps({"apps": apps}))
    log(json.dumps({"io": io_rep}))
    log(json.dumps({"torus32": {key: t32[key] for key in t32
                                if key not in ("counts", "kernel_runs",
                                               "ks_family_runs",
                                               "family_runs")}}))
    log(f"# whole script: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k5_main():
    """`chip_smoke.py --k5`: K5 alone on random key products at TFHEpp-L2,
    u=8 (G=79, u64 words) and L2_32, u=4 (G=158, u32 words), at B = 1 and
    K5_BATCH, timed as every phase times it (`k5_time`) beside its bound;
    where the package caps K5's tile by word width (`UBR_TILE`), K5 at
    K5_BATCH again under each cap of K5_TILES, its words the same; K4,
    which shares K5's combine helpers, at the u=4 PBS's shape (L2,
    B=BATCH, random inputs), its launches queued the same way; K4's and
    K5's registers and spills.  Prints one JSON line.  It calls the
    wrappers' entry points only, so a copy of it in another checkout times
    that checkout's kernels on the same inputs (a comparison on one
    card)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mosfhet_torch import ntt
    from mosfhet_torch.ops import _build, pbs_kernel as pk

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    max_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    build_s = _build.build(["ubr_phase1", "unfolded_rotate"])
    log(f"# card: {card}; build {build_s:.1f} s")
    log_build(sched_ptxas(_build.build_log["unfolded_rotate"],
                          "unfolded_rotate", "K4")
              + k5_ptxas(_build.build_log["ubr_phase1"]))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    caps = getattr(pk, "UBR_TILE", None)
    runs = []
    for name, bits, l, Bg_bit, u, primes in (
            ("L2", 64, 4, 9, U_UBR, ntt.primes_for_bound(
                ntt.external_product_bound(2048, 9, 4, 1))),
            ("L2_32", 32, L2_32["l"], L2_32["Bg_bit"], U_PBS,
             ntt.MASTER_PRIMES[-2:])):
        N, C, M, G = 2048, 2, 1 << u, 632 // u
        kp = pk.get_kernel_plan(N, primes, l, Bg_bit, 1, dev, bits)
        dtype = torch.int64 if bits == 64 else torch.int32
        info = torch.iinfo(dtype)
        su = torch.randint(info.min, info.max, (G, M, kp.J, C, N),
                           dtype=dtype, device=dev, generator=gen)
        rot64 = torch.randint(0, 2 * N + 1, (K5_BATCH, G, M),
                              dtype=torch.int32, device=dev, generator=gen)
        default = caps[bits] if isinstance(caps, dict) else None
        outs = {}
        for B, cap in ([(1, None), (K5_BATCH, None)] + [
                (K5_BATCH, c) for c in (K5_TILES if default else ())]):
            rot = rot64[:B].contiguous()
            if cap:
                caps[bits] = cap
            pk.ubr_phase1_combine(su, rot, kp)     # its first launch
            k5_ms, out = k5_time(pk.ubr_phase1_combine, su, rot, kp)
            if default:
                caps[bits] = default
            if cap:
                same_or_fail(f"K5 {name} B={B}: tile cap {cap} vs "
                             f"{default}", out, outs[B])
            else:
                outs[B] = out
            bound = ubr_phase1_bound(kp, B, G, M, max_clock)
            runs.append({"kernel": "K5", "width": name, "B": B, "G": G,
                         "M": M, "tile_cap": cap or default, "ms": k5_ms,
                         "bound_ms": bound["bound_ms"],
                         "bound_by": bound["bound_by"]})
            log(f"# K5 {name} u={u} B={B} tile cap {cap or default}: "
                f"{k5_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}), shared-memory ceiling "
                f"{smem_ceiling_ms(kp, B, G, M, max_clock):.4f} ms (derived, "
                "not measured)")
        same_or_fail(f"K5 {name}: ciphertext 0 at B={K5_BATCH} vs B=1",
                     outs[K5_BATCH][:1], outs[1])
        del su, rot64, outs, out
        torch.cuda.empty_cache()
    primes = ntt.primes_for_bound(ntt.external_product_bound(2048, 9, 4, 1))
    kp = pk.get_kernel_plan(2048, primes, 4, 9, 1, dev, 64)
    G, M = 632 // U_PBS, 1 << U_PBS
    su = torch.randint(-2**63, 2**63 - 1, (G, M, kp.J, kp.C, kp.N),
                       dtype=torch.int64, device=dev, generator=gen)
    acc = torch.randint(-2**63, 2**63 - 1, (BATCH, kp.C, kp.N),
                        dtype=torch.int64, device=dev, generator=gen)
    rot = torch.randint(0, 2 * kp.N + 1, (BATCH, G, M), dtype=torch.int32,
                        device=dev, generator=gen)
    pk.unfolded_rotate(acc, rot, su, kp)           # its first launch
    k4_ms, _ = queued_ms(lambda: pk.unfolded_rotate(acc, rot, su, kp),
                         K5_REPS)
    bound = unfolded_bound(kp, BATCH, G, M, max_clock)
    runs.append({"kernel": "K4", "width": "L2", "B": BATCH, "G": G, "M": M,
                 "ms": k4_ms, "bound_ms": bound["bound_ms"],
                 "bound_by": bound["bound_by"]})
    log(f"# K4 L2 u={U_PBS} B={BATCH}: {k4_ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    log(card)
    log(json.dumps({"k5": runs}))
    return 0


if __name__ == "__main__":
    modes = {"--torus32": torus32_main, "--k5": k5_main}
    sys.exit(modes.get(sys.argv[1] if sys.argv[1:] else None, main)())

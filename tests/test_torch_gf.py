"""GF(2^8) matrix apply: the port (garage_tpu_torch) against the reference.

The same uint32 slabs, made with numpy from a seed, go through the
reference's Pallas GF kernel (interpret mode, both of its dispatch
regimes), its numpy oracle, and the port's plain PyTorch version, for
RS(4,2) and RS(8,4) encode and RS(8,4) decode matrices.  Integer work:
the tolerance is exact equality.  The CUDA kernel runs only on a GPU:
tests/test_torch_cuda.py, and chip_smoke.py at full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garage_tpu.ops import gf256 as ref_gf256
from garage_tpu.ops.pallas_gf import PallasGf
from garage_tpu.ops.pallas_gf import gf_scalar_consts as ref_scalar_consts
from garage_tpu.ops.pallas_gf import reference_apply as ref_apply
from garage_tpu.ops.tpu_codec import gf_mask_consts
from garage_tpu_torch.ops import cuda_gf
from garage_tpu_torch.ops import gf256 as port_gf256

PRESENT = [0, 1, 3, 4, 6, 7, 8, 9]   # shards 2 and 5 lost


def _matrices():
    dec = ref_gf256.rs_decode_matrix(8, 4, PRESENT)
    return {
        "enc42": ref_gf256.rs_parity_matrix(4, 2),
        "enc84": ref_gf256.rs_parity_matrix(8, 4),
        "dec84_rows25": np.ascontiguousarray(dec[[2, 5]]),
    }


def _plain(mat, x):
    K = cuda_gf.consts_from_numpy(mat, "cpu")
    out = cuda_gf.gf_apply_plain(torch.from_numpy(x.view(np.int32)), K)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("s4", [100, 256, 511, 2048, 2500])
@pytest.mark.parametrize("name", ["enc42", "enc84", "dec84_rows25"])
def test_plain_matches_pallas_both_regimes(name, s4):
    """s4 < 2048 takes the reference's flat (batch-folded) kernel, s4 >=
    2048 its batched codeword walk; the port has one formulation."""
    mat = _matrices()[name]
    rng = np.random.default_rng(s4 * 7 + len(name))
    x = rng.integers(0, 2**32, (3, mat.shape[1], s4), dtype=np.uint32)
    pg = PallasGf(mat, tile=128 if s4 < 2048 else 1024, interpret=True)
    want = np.asarray(pg(jnp.asarray(x)))
    got = _plain(mat, x)
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref_apply(mat, x))
    assert np.array_equal(cuda_gf.reference_apply(mat, x), ref_apply(mat, x))


def test_full_decode_matrix_recovers_data():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (2, 8, 64), dtype=np.uint8)
    parity = ref_gf256.gf_matmul_blocks(ref_gf256.rs_parity_matrix(8, 4), data)
    full = np.concatenate([data, parity], axis=1)
    dec = port_gf256.rs_decode_matrix(8, 4, PRESENT)
    assert np.array_equal(dec, ref_gf256.rs_decode_matrix(8, 4, PRESENT))
    shards = np.ascontiguousarray(full[:, PRESENT])
    got = _plain(dec, shards.view(np.uint32))
    assert np.array_equal(got.view(np.uint8).reshape(data.shape), data)


def test_consts_round_trip_reference_forms():
    """consts_from_numpy takes a GF matrix, the reference's scalar
    constants, or its byte-replicated mask constants, and gives the same
    device constants for all three."""
    for mat in _matrices().values():
        want = ref_scalar_consts(mat)
        assert np.array_equal(cuda_gf.gf_scalar_consts(mat), want)
        for form in (mat, want, gf_mask_consts(mat)):
            K = cuda_gf.consts_from_numpy(form, "cpu")
            assert K.dtype == torch.int32 and K.is_contiguous()
            assert np.array_equal(K.numpy().view(np.uint32), want)
    with pytest.raises(ValueError):
        cuda_gf.consts_from_numpy(np.full((2, 4, 8), 0x1234, np.uint32), "cpu")
    with pytest.raises(ValueError):
        cuda_gf.consts_from_numpy(np.zeros((2, 4, 3), np.uint32), "cpu")


def test_gf256_copy_matches_reference():
    assert np.array_equal(port_gf256.GF_EXP, ref_gf256.GF_EXP)
    assert np.array_equal(port_gf256.GF_LOG, ref_gf256.GF_LOG)
    for k, m in ((4, 2), (8, 4), (10, 4)):
        assert np.array_equal(port_gf256.rs_parity_matrix(k, m),
                              ref_gf256.rs_parity_matrix(k, m))


def test_cudagf_on_cpu_and_wrapper_rules():
    mat = _matrices()["enc84"]
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2**32, (2, 8, 300), dtype=np.uint32)
    g = cuda_gf.CudaGf(mat, device="cpu")
    before = cuda_gf.launches
    out = g(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(out.numpy().view(np.uint32), ref_apply(mat, x))
    assert cuda_gf.launches == before  # the plain version, not the kernel
    with pytest.raises(ValueError):
        g(torch.zeros((1, 4, 8), dtype=torch.int32))
    meta = torch.empty((1, 8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gf.gf_apply(meta, g.consts)


# --- the kernel's dispatch, argument checks and arithmetic ----------------
#
# The CUDA kernel runs only on a GPU, but what the port hands it and how
# it computes can be held against the reference here: the constants it is
# given, byte-replicated as it stages them, go through a numpy emulation
# of its loop order and mask form (PRMT sign-replicate of x << (7 - b),
# then acc ^= mask & K) and must give what the reference's Pallas kernel
# gives in interpret mode.

RUNTIME_PAIRS = [(6, 3), (10, 5), (2, 1), (8, 5)]


@pytest.mark.parametrize("kr", list(cuda_gf.INSTANTIATIONS) + RUNTIME_PAIRS)
def test_dispatch_picks_the_instantiation(kr):
    k, r = kr
    want = f"k{k}r{r}" if kr in cuda_gf.INSTANTIATIONS else "runtime"
    assert cuda_gf.instantiation(k, r) == want
    assert cuda_gf.instantiation(k, r, runtime=True) == "runtime"


def test_instantiations_cover_the_ports_shapes():
    """Encode at RS(8,4) and RS(4,2), degraded-read decode of 1..m rows,
    full decode r = k."""
    for k, m in ((8, 4), (4, 2)):
        for r in list(range(1, m + 1)) + [k]:
            assert (k, r) in cuda_gf.INSTANTIATIONS


def test_instantiations_are_the_kernel_sources_list():
    """The wrapper's INSTANTIATIONS are read from the macro that the
    kernel's C++ dispatch expands, so the two cannot drift apart."""
    src = (cuda_gf._build.CSRC / "gf_apply.cu").read_text()
    assert "GF_APPLY_INSTANTIATIONS(GF_APPLY_CASE)" in src
    assert cuda_gf.INSTANTIATIONS == ((8, 1), (8, 2), (8, 3), (8, 4), (8, 8),
                                      (4, 1), (4, 2), (4, 4))


def _misaligned(b, k, s4):
    base = torch.zeros(1 + b * k * s4, dtype=torch.int32)
    return base[1:].view(b, k, s4)


@pytest.mark.parametrize("case", ["ok", "dtype", "dims", "misaligned",
                                  "k_mismatch", "consts_dtype",
                                  "consts_shape", "not_contiguous"])
def test_kernel_argument_checks(case):
    K = cuda_gf.consts_from_numpy(ref_gf256.rs_parity_matrix(8, 4), "cpu")
    x = torch.zeros((2, 8, 12), dtype=torch.int32)
    args = {
        "ok": (x, K),
        "dtype": (x.to(torch.int64), K),
        "dims": (x.view(16, 12), K),
        "misaligned": (_misaligned(2, 8, 12), K),
        "k_mismatch": (torch.zeros((2, 4, 12), dtype=torch.int32), K),
        "consts_dtype": (x, K.to(torch.int64)),
        "consts_shape": (x, K[..., :4]),
        "not_contiguous": (x.transpose(0, 1), K),
    }[case]
    if case == "ok":
        cuda_gf.check_args(*args)
        return
    with pytest.raises(ValueError):
        cuda_gf.check_args(*args)


def _prmt(a: np.ndarray, b: int, sel: int) -> np.ndarray:
    """PTX prmt.b32 (default mode) on uint32 arrays: result byte n is
    byte (sel_n & 7) of the 8 bytes {b, a}, or, when sel_n & 8, that
    byte's top bit replicated over all 8 bits."""
    src = (np.uint64(b) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros(a.shape, np.uint64)
    for n in range(4):
        nib = (sel >> (4 * n)) & 0xF
        byte = (src >> np.uint64(8 * (nib & 7))) & np.uint64(0xFF)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF),
                            np.uint64(0))
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


def _emulate_kernel(x: np.ndarray, consts: np.ndarray, rows_per_pass: int):
    """csrc/gf_apply.cu's arithmetic in numpy: x (B, k, S4) uint32,
    consts (r, k, 8) the wrapper's int32 scalar constants.  Columns of 4
    words (the tail zero-padded, as the guarded loads read it), output
    rows in passes of `rows_per_pass`, for each input row i and bit b one
    mask consumed at once by every accumulator of the pass."""
    b_, k, s4 = x.shape
    r = consts.shape[0]
    krep = consts.astype(np.uint32) * np.uint32(0x01010101)   # staging
    ncol = (s4 + 3) // 4
    xp = np.zeros((b_, k, 4 * ncol), np.uint32)
    xp[..., :s4] = x
    xv = xp.reshape(b_, k, ncol, 4)
    out = np.zeros((b_, r, ncol, 4), np.uint32)
    for p0 in range(0, r, rows_per_pass):
        rows = min(rows_per_pass, r - p0)
        acc = np.zeros((rows, b_, ncol, 4), np.uint32)
        for i in range(k):
            xi = xv[:, i]
            for h in range(2):
                kc = krep[p0:p0 + rows, i, 4 * h:4 * h + 4]      # LDS.128
                for bb in range(4):
                    b = 4 * h + bb
                    m = _prmt((xi << np.uint32(7 - b)).astype(np.uint32),
                              0, 0xBA98)
                    for p in range(rows):
                        acc[p] ^= m & kc[p, bb]
        out[:, p0:p0 + rows] = np.moveaxis(acc, 0, 1)
    return out.reshape(b_, r, 4 * ncol)[..., :s4]


_PALLAS_CASES = ([(kr, 301) for kr in cuda_gf.INSTANTIATIONS]
                 + [((8, 4), 2501), ((8, 2), 2501)]
                 + [(kr, 301) for kr in RUNTIME_PAIRS[:2]])


@pytest.mark.parametrize("kr,s4", _PALLAS_CASES)
def test_kernel_emulation_matches_pallas(kr, s4):
    """One Pallas run (interpret mode; S4 301 takes its batch-folded
    `_apply_flat`, 2501 its `_apply_batched`) per (k, r); the emulation
    must match it at the odd S4 (the kernel's guarded tail), at the
    largest multiple of 4 below it (its 16-byte column path) and at
    S4 = 3, for the body the wrapper picks and for the runtime body."""
    k, r = kr
    rng = np.random.default_rng(100 * k + r + s4)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    x = rng.integers(0, 2**32, (2, k, s4), dtype=np.uint32)
    pg = PallasGf(mat, tile=128 if s4 < 2048 else 1024, interpret=True)
    want = np.asarray(pg(jnp.asarray(x)))
    consts = cuda_gf.consts_from_numpy(mat, "cpu").numpy()
    fixed = cuda_gf.instantiation(k, r) != "runtime"
    passes = [r, 4] if fixed else [4]
    for n in (s4, s4 - s4 % 4, 3):
        for rows in passes:
            got = _emulate_kernel(np.ascontiguousarray(x[..., :n]), consts,
                                  rows)
            assert np.array_equal(got, want[..., :n]), (n, rows)

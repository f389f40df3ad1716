"""T1, the GF(2^8) tuning sweep's kernel, against the reference's Pallas
kernels.

``scripts/pallas_tune.py`` is loaded by path and its three kernel bodies
(``_kernel_orig``, ``_kernel_acc``, ``_kernel_accs``) run through
``pl.pallas_call`` in interpret mode with the BlockSpecs of its
``_pallas_once`` at a small n and a tile of 128; the same seeded words go
through the port's ``gf_tune_plain`` (each variant's loop order, the plain
version of ``csrc/gf_tune.cu``) and ``gf_tune`` on CPU tensors.  Both
must equal each other and ``garage_tpu.ops.pallas_gf.reference_apply``
exactly (integer work).  The kernel itself is held against
``gf_tune_plain`` on the card by tests/test_torch_cuda.py.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garage_tpu.ops import gf256 as ref_gf256
from garage_tpu.ops.pallas_gf import reference_apply
from garage_tpu.ops.tpu_codec import gf_mask_consts
from garage_tpu_torch.tools import gf_tune as T

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pallas_tune():
    """scripts/pallas_tune.py as a module.  Loading it sets JAX's
    compilation cache directory; the setting is put back afterwards."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "pallas_tune", REPO / "scripts" / "pallas_tune.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


def _pallas_interpret(mod, x, consts, k, r, tile, variant):
    """``pallas_tune._pallas_once`` with interpret=True."""
    from jax.experimental import pallas as pl

    n = x.shape[-1]
    kern = {"orig": mod._kernel_orig, "acc": mod._kernel_acc,
            "accs": mod._kernel_accs}[variant]
    return pl.pallas_call(
        functools.partial(kern, k, r),
        grid=(n // tile,),
        in_specs=[
            pl.BlockSpec((k, tile), lambda j: (0, j)),
            pl.BlockSpec((r, k, 8), lambda j: (0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((r, tile), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((r, n), jnp.uint32),
        interpret=True,
    )(x, consts)


@pytest.mark.parametrize("variant", T.VARIANTS)
@pytest.mark.parametrize("k,r", T.SHAPES)
def test_variant_matches_pallas_kernel(pallas_tune, variant, k, r):
    rng = np.random.default_rng(k * 10 + r)
    mat = ref_gf256.rs_parity_matrix(k, r)
    ncw, s4 = 2, 256
    u32 = rng.integers(0, 2**32, (ncw, k, s4), dtype=np.uint32)
    flat = T.fold(u32)
    consts = gf_mask_consts(mat)
    assert np.array_equal(consts, T.mask_consts(mat))
    want = reference_apply(mat, u32)
    got_pallas = np.asarray(_pallas_interpret(
        pallas_tune, jnp.asarray(flat), jnp.asarray(consts), k, r, 128,
        variant))
    assert np.array_equal(T.unfold(got_pallas, ncw), want)
    x = torch.from_numpy(flat.view(np.int32))
    c = torch.from_numpy(consts.view(np.int32))
    plain = T.gf_tune_plain(x, c, variant).numpy().view(np.uint32)
    assert np.array_equal(plain, got_pallas)
    before = T.launches
    wrapped = T.gf_tune(x, c, variant, 128).numpy().view(np.uint32)
    assert np.array_equal(wrapped, got_pallas)
    assert T.launches == before   # the CPU takes the plain version


def test_sweep_fold_matches_reference_layout(pallas_tune):
    """The port folds codewords exactly as the reference sweep does
    (``pallas_tune.py:193``), and its bound is the bytes bound of the
    48 MiB the sweep's shape moves."""
    u32 = np.arange(3 * 8 * 5, dtype=np.uint32).reshape(3, 8, 5)
    assert np.array_equal(T.fold(u32), np.swapaxes(u32, 0, 1).reshape(8, -1))
    assert pallas_tune.N == T.NBLOCKS and pallas_tune.BLOCK == T.BLOCK
    assert (pallas_tune.K, pallas_tune.M) == (T.K, T.M)
    b = T.bound(T.K, T.M, T.NBLOCKS * T.BLOCK // (4 * T.K))
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == 48 * 2**20 + 4 * T.M * T.K * 8
    assert 0.0149 < b["bound_ms"] < 0.0152


def test_wrapper_guards(monkeypatch, capsys):
    x = torch.zeros((8, 256), dtype=torch.int32)
    c = torch.zeros((4, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown variant"):
        T.gf_tune(x, c, "fast", 128)
    with pytest.raises(ValueError, match="unknown variant"):
        T.gf_tune_plain(x, c, "fast")
    # the sweep needs the card: without one it fails and prints no result
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert T.main(["--reps", "1"]) == 2
    assert capsys.readouterr().out == ""


# --- the kernel's launch shapes, argument checks and arithmetic -----------
#
# The CUDA kernel runs only on a GPU, but the launches the wrapper asks for
# and the kernel's loop order can be held to the reference here: the
# launch shapes must fill the card at every tile and cover every word once,
# and a numpy emulation of each variant's per-thread arithmetic (one
# 16-byte column per thread, the constants read four b at a time as the
# LDS.128 reads them) must give what the Pallas kernel gives in interpret
# mode.

SWEEP_N = T.NBLOCKS * T.BLOCK // (4 * T.K)      # 2^20 words a row


@pytest.mark.parametrize("tile", T.TILES)
def test_launch_shape_fills_the_card_at_every_tile(tile):
    """Every sweep tile launches the same 1024 blocks of 256 threads, at
    least two per SM of the H100's 132, with no cluster."""
    shape = T.launch_shape(tile, SWEEP_N)
    assert shape == {"grid": 1024, "block": 256, "block_words": 1024}
    assert shape["grid"] >= 2 * 132


def test_small_tile_is_one_block():
    assert T.launch_shape(128, 1024) == {"grid": 8, "block": 32,
                                         "block_words": 128}


@pytest.mark.parametrize("tile,n", [(96, 960), (2048, 8192), (4096, 6144),
                                    (128, 1000)])
def test_launch_shape_rejects_tiles_the_kernel_does_not_take(tile, n):
    with pytest.raises(ValueError, match="tile"):
        T.launch_shape(tile, n)


def _misaligned(k, n):
    base = torch.zeros(1 + k * n, dtype=torch.int32)
    return base[1:].view(k, n)


@pytest.mark.parametrize("case", ["ok", "misaligned", "dtype", "dims",
                                  "consts_dtype", "consts_shape", "kr",
                                  "tile", "not_divisible", "not_contiguous",
                                  "variant"])
def test_kernel_argument_checks(case):
    x = torch.zeros((8, 256), dtype=torch.int32)
    c = torch.zeros((4, 8, 8), dtype=torch.int32)
    args = {
        "ok": (x, c, "acc", 128),
        "misaligned": (_misaligned(8, 256), c, "acc", 128),
        "dtype": (x.to(torch.int64), c, "acc", 128),
        "dims": (x.view(8, 2, 128), c, "acc", 128),
        "consts_dtype": (x, c.to(torch.int64), "acc", 128),
        "consts_shape": (x, c[..., :4], "acc", 128),
        "kr": (x, c[:2], "acc", 128),                  # (8, 2) is not built
        "tile": (x, c, "acc", 256),
        "not_divisible": (x[:, :192].contiguous(), c, "acc", 128),
        "not_contiguous": (torch.zeros((256, 8), dtype=torch.int32).t(), c,
                           "acc", 128),
        "variant": (x, c, "fast", 128),
    }[case]
    if case == "ok":
        T.check_args(*args)
        return
    with pytest.raises(ValueError):
        T.check_args(*args)


def test_issue_bound_of_a_census():
    """The census's ALU-only instructions over 64 lanes bound the launch
    when they outnumber half of all issued ones; at that time the launch
    issues 64 ALU lanes per SM per clock."""
    cls = {"alu": 1539, "fma": 266, "mem": 90, "uniform": 17, "other": 12,
           "total": 1924}
    got = T.issue(cls, SWEEP_N, 1.0)
    threads = SWEEP_N // T.WORDS
    want = threads * 1539 / 64 / (132 * 1.98e9) * 1e3
    assert got["issue_bound_ms"] == pytest.approx(want)
    assert 0.0240 < want < 0.0243
    at_bound = T.issue(cls, SWEEP_N, want)
    assert at_bound["alu_lanes_per_sm_clock"] == pytest.approx(64)
    assert T.issue(None, SWEEP_N, 1.0)["issue_bound_ms"] is None


def test_census_names_the_kernels_template():
    """The census picks the kernel by its mangled name: the template's
    parameters must be (variant, k, r) in that order."""
    src = (REPO / "garage_tpu_torch" / "csrc" / "gf_tune.cu").read_text()
    m = re.search(r"template <([^>]*)>\s*__global__[^(]*\([^)]*\)\s*"
                  r"gf_tune_kernel\(", src)
    assert m and m.group(1) == "int VARIANT, int K, int R"


def _mask(v: np.ndarray, b: int, variant: str) -> np.ndarray:
    m1 = (v >> np.uint32(b)) & np.uint32(0x01010101)
    if variant == "accs":
        return ((m1 << np.uint32(8)) - m1).astype(np.uint32)
    return (m1 * np.uint32(0xFF)).astype(np.uint32)


def _emulate_kernel(x: np.ndarray, consts: np.ndarray, variant: str,
                    shape: dict) -> np.ndarray:
    """csrc/gf_tune.cu in numpy: x (k, n) and consts (r, k, 8) uint32.
    Block g owns words [g * block_words, ...) of every row and its
    `block` threads walk its 16-byte columns, blockDim apart; each column
    is computed in the variant's loop order, the constants read as
    (p, i, h) groups of four b (sk4[(p * K + i) * 2 + h])."""
    k, n = x.shape
    r = consts.shape[0]
    sk4 = consts.reshape(r * k * 2, 4)
    bw, threads = shape["block_words"], shape["block"]
    # the word each (block, thread, pass) starts its column at
    starts = [g * bw + c * T.WORDS for g in range(shape["grid"])
              for t in range(threads) for c in range(t, bw // T.WORDS, threads)]
    assert sorted(starts) == list(range(0, n, T.WORDS))    # each column once
    cols = np.asarray(starts)
    xs = np.stack([x[:, cols + j] for j in range(T.WORDS)], -1)  # (k, ncol, 4)
    acc = np.zeros((r,) + xs.shape[1:], np.uint32)
    if variant == "orig":
        masks = [_mask(xs[i], b, variant) for i in range(k) for b in range(8)]
        for p in range(r):
            for i in range(k):
                for h in range(2):
                    kc = sk4[(p * k + i) * 2 + h]
                    for bb in range(4):
                        acc[p] ^= masks[i * 8 + 4 * h + bb] & kc[bb]
    else:
        for i in range(k):
            for h in range(2):
                kc = [sk4[(p * k + i) * 2 + h] for p in range(r)]
                for bb in range(4):
                    m = _mask(xs[i], 4 * h + bb, variant)
                    for p in range(r):
                        acc[p] ^= m & kc[p][bb]
    out = np.zeros((r, n), np.uint32)
    for j in range(T.WORDS):
        out[:, cols + j] = acc[..., j]
    return out


@pytest.mark.parametrize("variant", T.VARIANTS)
@pytest.mark.parametrize("k,r", T.SHAPES)
def test_kernel_emulation_matches_pallas(pallas_tune, variant, k, r):
    """The emulation, at the launch the wrapper asks for, on a row of 16
    tiles of 128 words (blocks of 32 threads, one column each) and on one
    of 2 tiles of 4096 words (4 blocks each of 256 threads), equals the
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(31 * k + r)
    mat = ref_gf256.rs_parity_matrix(k, r)
    consts = gf_mask_consts(mat)
    for tile, n in ((128, 2048), (4096, 8192)):
        x = rng.integers(0, 2**32, (k, n), dtype=np.uint32)
        want = np.asarray(_pallas_interpret(
            pallas_tune, jnp.asarray(x), jnp.asarray(consts), k, r,
            min(tile, 1024), variant))
        shape = T.launch_shape(tile, n)
        got = _emulate_kernel(x, consts, variant, shape)
        assert np.array_equal(got, want), (tile, shape)


# --- the cold-L2 timer (tools/timing.py) ----------------------------------


def test_evict_l2_reads_and_leaves_its_buffer():
    from garage_tpu_torch.tools import timing

    buf = torch.arange(64, dtype=torch.uint8)
    timing.evict_l2(buf)
    assert torch.equal(buf, torch.arange(64, dtype=torch.uint8))
    # each half of the flush buffer is larger than the H100's 50 MB L2
    assert timing.FLUSH_BYTES // 2 > 50e6 and timing.FLUSH_BYTES % 16 == 0


class _Card:
    """A card that runs what is queued in order, on its own clock: a
    call takes 1 ms and leaves `dirty` ms of write-back in the L2, which
    the next read of a flush buffer (2 ms) pays; call number `stall`
    takes 50 ms more, as when the host leaves the queue empty."""

    def __init__(self, dirty, stall=None):
        self.clock, self.dirty, self.pending = 0.0, dirty, 0.0
        self.calls, self.stall = 0, stall

    def call(self):
        self.calls += 1
        self.clock += 1.0 + 50.0 * (self.calls == self.stall)
        self.pending = self.dirty

    def evict(self, buf):
        assert buf.numel() == 64 << 20        # one half of the flush buffer
        self.clock += 2.0 + self.pending
        self.pending = 0.0

    def event(self, enable_timing=False):
        card = self

        class Event:
            def record(self):
                self.t = card.clock

            def elapsed_time(self, end):
                return end.t - self.t

        return Event()


@pytest.mark.parametrize("reps", [1, 100])
@pytest.mark.parametrize("dirty", [0.0, 0.5])
def test_queued_ms_charges_the_write_back_and_takes_off_the_read(
        monkeypatch, reps, dirty):
    """With a flush buffer the window of a call runs on through the read
    that writes its dirty lines back, and the read's own time is taken
    off: what is left is the call and its write-back, over one batch and
    over several."""
    from garage_tpu_torch.tools import timing

    card = _Card(dirty)
    monkeypatch.setattr(timing, "evict_l2", card.evict)
    monkeypatch.setattr(torch.cuda, "Event", card.event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    flush = torch.empty(timing.FLUSH_BYTES, dtype=torch.uint8)
    assert timing.queued_ms(card.call, reps, flush) == pytest.approx(1.0 + dirty)
    assert timing.queued_ms(card.call, reps) == pytest.approx(1.0)


def test_queued_ms_with_a_flush_is_not_moved_by_one_stalled_window(
        monkeypatch):
    from garage_tpu_torch.tools import timing

    card = _Card(0.5, stall=40)
    monkeypatch.setattr(timing, "evict_l2", card.evict)
    monkeypatch.setattr(torch.cuda, "Event", card.event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    flush = torch.empty(timing.FLUSH_BYTES, dtype=torch.uint8)
    assert timing.queued_ms(card.call, 100, flush) == pytest.approx(1.5)
    assert card.calls == 1 + 1 + 100          # warm-up, host estimate, reps

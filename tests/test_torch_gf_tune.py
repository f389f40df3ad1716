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

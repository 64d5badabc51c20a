"""Morton codes and cell grouping of the port against the JAX package.

Both must be IDENTICAL: group membership decides every window. The cloud
is a coarse lattice with repeated points, so Morton codes tie often and
the sort's tie order (stable in both) decides the groups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu.ops import grouping as jg
from planetmodel_sph_tpu.ops import morton as jm
from planetmodel_sph_tpu_torch.ops import grouping as tg
from planetmodel_sph_tpu_torch.ops import morton as tm


def _lattice(n, seed):
    rng = np.random.default_rng(seed)
    # 9 lattice points per axis over [-4, 4]: ~700 distinct sites for n
    # points, so many particles share a site and hence a Morton code
    pos = rng.integers(-4, 5, size=(n, 3)).astype(np.float32) * 1.0
    pos[: n // 4] += rng.normal(0, 0.3, (n // 4, 3)).astype(np.float32)
    return pos


def _box(pos):
    return pos.min(axis=0), pos.max(axis=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_codes_identical(seed):
    pos = _lattice(3000, seed)
    lo, hi = _box(pos)
    ref = np.asarray(jm.encode(jnp.asarray(pos), jnp.asarray(lo),
                               jnp.asarray(hi)))
    out = tm.encode(torch.from_numpy(pos), torch.from_numpy(lo),
                    torch.from_numpy(hi)).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    assert len(np.unique(ref)) < len(ref) // 2      # ties are plentiful
    bits = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(
        tm.expand_bits(torch.from_numpy(bits)).numpy(),
        np.asarray(jm.expand_bits(jnp.asarray(bits))).astype(np.int64))


@pytest.mark.parametrize("n,bsz,lg", [(3000, 64, 4), (1000, 32, 2),
                                      (517, 16, 3)])
def test_cell_groups_identical(n, bsz, lg):
    pos = _lattice(n, n)
    lo, hi = _box(pos)
    ref = jg.cell_groups(jnp.asarray(pos), jnp.asarray(lo), jnp.asarray(hi),
                         bsz, lg)
    out = tg.cell_groups(torch.from_numpy(pos), torch.from_numpy(lo),
                         torch.from_numpy(hi), bsz, lg)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert out.live.shape[0] == tg.n_groups_static(n, bsz, lg) \
        == jg.n_groups_static(n, bsz, lg)
    assert tg.effective_level(n, bsz, lg) == jg.effective_level(n, bsz, lg)


def test_production_group_count():
    # the 100k production grouping: level 3 (512 cells), 2067 static
    # groups of 64
    assert tg.effective_level(100_000, 64, 4) == 3
    assert tg.n_groups_static(100_000, 64, 4) == 2067 \
        == jg.n_groups_static(100_000, 64, 4)

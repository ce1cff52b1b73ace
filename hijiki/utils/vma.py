"""Varying-manual-axes (vma) plumbing for shard_map's consistency check.

Under ``jax.shard_map(..., check_vma=True)`` every array carries the set of
mesh axes it varies over. Loop carries must enter ``while_loop``/``fori_loop``
with the same vma they exit with — but renderer loop inits mix replicated
constants (``jnp.zeros``) with per-shard ray data, so the constant carries
must be explicitly promoted to varying. These helpers derive the target vma
from a reference array (some per-shard input) and are exact no-ops outside
shard_map (empty vma), so the same code serves sharded and unsharded traces.

This keeps the check ON: a future sharding bug
that makes per-device values diverge where the code assumes replication is
caught at trace time instead of being silently psum-masked on uniform meshes.
"""

from __future__ import annotations

import jax


def vma_of(ref) -> frozenset:
    """The varying-manual-axes of ``ref`` (empty outside shard_map)."""
    return jax.typeof(ref).vma


def match_vma(tree, ref):
    """Promote every leaf of ``tree`` to carry at least ``ref``'s vma."""
    axes = vma_of(ref)
    if not axes:
        return tree

    def fix(x):
        missing = axes - jax.typeof(x).vma
        for ax in missing:
            x = jax.lax.pcast(x, ax, to="varying")
        return x

    return jax.tree.map(fix, tree)


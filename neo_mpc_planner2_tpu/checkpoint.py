"""Checkpoint / resume for the control state (SURVEY.md §5 checkpoint row).

The reference's persistent state is in-memory only (initial_guess py:136,
last_control py:117, waiting_time py:361, old_goal py:146) and is lost on
restart. Here the whole `ControlState` pytree (single or batched) round-trips
through a single .npz file. A directory path goes through orbax instead
(async, sharded, multi-host fleets); orbax is optional, and without it a
directory path raises an error that names the .npz form.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .engine import ControlState

__all__ = ["save_state", "load_state"]

# Derived, not hand-listed: a future ControlState field must round-trip too —
# a stale hand list would write silently-incomplete checkpoints whose loss is
# discovered only at restore time (round-5 review).
_FIELDS = [f.name for f in dataclasses.fields(ControlState)]


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "a directory checkpoint path needs the optional orbax package, "
            "which is not installed; use a file path ending in .npz "
            "(e.g. 'state.npz') for the built-in numpy format") from e
    return ocp


def save_state(path: str, state: ControlState) -> None:
    """Save to .npz (file path) or via orbax (directory path, multi-host safe)."""
    if path.endswith(".npz"):
        np.savez(path, **{f: np.asarray(getattr(state, f)) for f in _FIELDS})
        return
    ocp = _orbax()
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), state, force=True)
    ckptr.wait_until_finished()


def load_state(path: str, template: Optional[ControlState] = None) -> ControlState:
    """Inverse of save_state. For orbax, `template` provides the pytree
    structure/shardings to restore into."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return ControlState(**{f: jnp.asarray(z[f]) for f in _FIELDS})
    ocp = _orbax()
    ckptr = ocp.StandardCheckpointer()
    restored = ckptr.restore(os.path.abspath(path), template)
    # Template-LESS restores come back as a plain dict (orbax has no target
    # structure) — that is exactly the case needing the ControlState wrap;
    # the old guard required a template and returned the raw dict otherwise,
    # breaking the "inverse of save_state" contract (round-5 review).
    if not isinstance(restored, ControlState) and isinstance(restored, dict):
        restored = ControlState(**{f: jnp.asarray(restored[f])
                                   for f in _FIELDS})
    return restored

"""Engine-carry checkpoints: atomic snapshots of a round engine's full
carry plus its trajectory so far, and the matching resume side.

A carry checkpoint has three parts:

* ``state``: a dict of named trees (params, optimizer state,
  ``ClientPopulation``, ``SelectorState``, RNG keys, the budget ledger).
  Only the leaves are stored, in the reference's ``jax.tree.leaves``
  order (:func:`tree_flatten`), so a file written by either package loads
  in the other; on load they are put back into a caller-supplied template
  tree, shape and dtype checked against it.
* ``data``: plain packable host data (trajectory arrays, history lists,
  wall-clock scalars), returned as stored.
* ``meta``: a flat dict identifying the run; on load any disagreement
  with the run about to continue is a :class:`CheckpointError`.

Floats round-trip through raw bytes, so a restored carry is bit-identical
to the live one: resuming at round r equals the uninterrupted run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import msgpack
import numpy as np

from repro_torch.checkpoint.checkpoint import (CheckpointError, _pack,
                                               _read_verified, _unpack,
                                               _write_atomic, from_file,
                                               to_file)

TreeDef = Callable[[Iterator[Any]], Any]


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """Leaves in ``jax.tree.leaves`` order, and a function that rebuilds
    the tree from an iterator of leaves. Dict keys go in sorted order,
    NamedTuple and dataclass fields in declaration order, lists and tuples
    in order; ``None`` is an empty node; anything else is a leaf."""
    if tree is None:
        return [], lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                lambda it: {k: p[1](it) for k, p in zip(keys, parts)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [tree_flatten(v) for v in tree]
        return ([leaf for p in parts for leaf in p[0]],
                lambda it: type(tree)(*(p[1](it) for p in parts)))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        parts = [tree_flatten(getattr(tree, n)) for n in names]
        return ([leaf for p in parts for leaf in p[0]],
                lambda it: type(tree)(**{n: p[1](it)
                                         for n, p in zip(names, parts)}))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        return ([leaf for p in parts for leaf in p[0]],
                lambda it: type(tree)(p[1](it) for p in parts))
    return [tree], lambda it: next(it)


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = treedef(it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def checkpoint_path_for(path: str, rnd: int) -> str:
    """``path`` for round ``rnd``: a literal ``{round}`` expands to the
    round number (one file per snapshot); without it the same file is
    atomically overwritten each time (latest only)."""
    return path.format(round=rnd) if "{round}" in path else path


def save_engine_checkpoint(path: str, *, rnd: int,
                           state: Dict[str, Any],
                           data: Optional[Dict[str, Any]] = None,
                           meta: Optional[Dict[str, Any]] = None) -> None:
    """Atomically snapshot an engine carry at (completed) round ``rnd``."""
    packed_state = {name: [_pack(to_file(leaf))
                           for leaf in tree_flatten(tree)[0]]
                    for name, tree in state.items()}
    payload = {
        "kind": "engine-carry",
        "round": int(rnd),
        "state": packed_state,
        "data": _pack(dict(data or {})),
        "meta": _pack(dict(meta or {})),
    }
    _write_atomic(path, msgpack.packb(payload, use_bin_type=True))


def load_engine_checkpoint(path: str, templates: Dict[str, Any],
                           expect_meta: Optional[Dict[str, Any]] = None,
                           ) -> Tuple[int, Dict[str, Any], Dict[str, Any],
                                      Dict[str, Any]]:
    """Restore an engine carry saved by :func:`save_engine_checkpoint`
    (here or by the reference). ``templates`` maps each state name to a
    tree of tensors with the structure, shapes, dtypes and devices the
    resuming run would have built fresh. Returns ``(round, state, data,
    meta)``. Raises :class:`CheckpointError` on framing or CRC failure,
    missing or mismatched state components, or an ``expect_meta``
    disagreement. Its leaves are tensors of host data copied to the
    device, so it runs inside the caller's
    ``analysis.runtime.setup_transfers()`` window (legal under
    ``strict_mode``); saving copies with ``.cpu()`` and reads nothing
    else (``checkpoint.to_file``)."""
    payload = _read_verified(path)
    if not isinstance(payload, dict) or payload.get("kind") != "engine-carry":
        kind = payload.get("kind") if isinstance(payload, dict) else None
        raise CheckpointError(
            f"{path!r} is not an engine-carry checkpoint (kind={kind!r})")
    meta = _unpack(payload.get("meta") or {})
    if expect_meta:
        bad = [f"{k}: checkpoint has {meta.get(k)!r}, run expects {v!r}"
               for k, v in expect_meta.items() if meta.get(k) != v]
        if bad:
            raise CheckpointError(
                f"checkpoint {path!r} belongs to a different run: "
                + "; ".join(bad))
    stored = payload.get("state", {})
    state: Dict[str, Any] = {}
    for name, template in templates.items():
        if name not in stored:
            raise CheckpointError(
                f"checkpoint {path!r} has no state component {name!r} "
                f"(has {sorted(stored)})")
        leaves = [_unpack(entry) for entry in stored[name]]
        t_leaves, treedef = tree_flatten(template)
        if len(leaves) != len(t_leaves):
            raise CheckpointError(
                f"checkpoint {path!r} state {name!r} has {len(leaves)} "
                f"leaves, template expects {len(t_leaves)}")
        restored = []
        for i, (loaded, tmpl) in enumerate(zip(leaves, t_leaves)):
            la, ta = np.asarray(loaded), to_file(tmpl)
            if la.shape != ta.shape or la.dtype != ta.dtype:
                raise CheckpointError(
                    f"checkpoint {path!r} state {name!r} leaf {i}: stored "
                    f"{la.dtype}{list(la.shape)} does not match template "
                    f"{ta.dtype}{list(ta.shape)}")
            restored.append(from_file(la, tmpl.dtype, tmpl.device))
        state[name] = tree_unflatten(treedef, restored)
    return int(payload["round"]), state, _unpack(payload["data"]), meta


def segment_bounds(start: int, total: int, every: Optional[int],
                   ) -> Iterator[Tuple[int, int]]:
    """Split rounds ``(start, total]`` into segments ``(a, b]`` that break
    at absolute multiples of ``every`` (checkpoint boundaries stay aligned
    whether the run started at 0 or resumed mid-way). ``every`` of
    ``None``/0 yields one segment."""
    if total < 0 or start > total:
        raise ValueError(f"bad segment range start={start} total={total}")
    if every is None or every <= 0:
        if start < total:
            yield (start, total)
        return
    a = start
    while a < total:
        b = min(total, (a // every + 1) * every)
        yield (a, b)
        a = b


class CarryCheckpointer:
    """Cadence and path bookkeeping for periodic engine-carry snapshots:
    one is due every ``every`` completed rounds and always at the last,
    so a finished run leaves a resumable file behind."""

    def __init__(self, path: str, every: int, total_rounds: int,
                 meta: Optional[Dict[str, Any]] = None):
        if not path:
            raise ValueError("checkpoint_every is set but checkpoint_path "
                             "is empty")
        if every <= 0:
            raise ValueError(f"checkpoint_every must be positive, got {every}")
        self.path = path
        self.every = every
        self.total = total_rounds
        self.meta = dict(meta or {})

    def due(self, rnd: int) -> bool:
        return rnd % self.every == 0 or rnd == self.total

    def path_for(self, rnd: int) -> str:
        return checkpoint_path_for(self.path, rnd)

    def save(self, rnd: int, state: Dict[str, Any],
             data: Optional[Dict[str, Any]] = None) -> str:
        out = self.path_for(rnd)
        save_engine_checkpoint(out, rnd=rnd, state=state, data=data,
                               meta=self.meta)
        return out

"""Checkpoint / resume of a chain's operator state, in the JAX package's files.

Counterpart of ``windflow_tpu/runtime/checkpoint.py``. Every operator's state
is a tree of tensors, so a checkpoint is structural: :func:`save_chain`
writes each operator's state (and stream-position metadata) to an ``.npz``
and :func:`load_chain` restores it. The files are the JAX package's format,
so a stream checkpointed by one package resumes in the other:

- state leaves are stored as ``op<i>_leaf<j>`` in JAX's flatten order (dict
  keys sorted, dataclass fields in declaration order, ``None`` an empty
  subtree), and ``__meta__`` carries each operator's leaf paths as
  ``jax.tree_util.keystr`` prints them (``['l']['key']``, ``.panes``,
  ``[0]``), computed here without JAX (:func:`leaf_paths`);
- a restore matches leaves by path, so fields a file lacks keep the
  template's value (a copy) and saved fields the chain lacks are skipped; a
  file without paths restores positionally, with the legacy trailing-leaf
  tolerance;
- writes are atomic (a temp file in the target directory, then
  ``os.replace``) and ``__meta__`` carries a per-array sha256 that a load
  verifies before touching the chain (:class:`CheckpointCorrupt`);
- lineage (``keep > 1``): saves rotate through ``<stem>.<seq>.npz`` files
  named by ``<stem>.manifest.json`` (whole-file sha256 per entry, pruned to
  the last ``keep``); a load walks it newest to oldest and restores the
  newest valid entry;
- the ``checkpoint.save`` (``kind="torn"`` leaves half a file behind, then
  raises) and ``checkpoint.load`` fault sites of ``runtime/faults.py``.

A restored state is made of fresh tensors on the chain's device (no alias of
the template: Win_Seq updates its rings in place and marks a consumed state).
A chain with captured graphs copies the restored state into the graphs'
static state at its next replay (``runtime/graphs.py``).

Not ported, and refused by name: sharded checkpoints and the re-sharding
handoffs (``save_sharded``, ``load_sharded``, ``seal_handoff``,
``discard_handoffs``: ROADMAP Queue 1 item 14) and the tiered state's
manifests (a file that carries them raises on load: item 13). A skipped
lineage entry and a fallback are counted in the recovery counters and
journaled (``checkpoint_invalid``, ``checkpoint_fallback``), as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import journal as _journal
from . import faults as _faults

#: reserved __meta__ keys (stripped from the dict load_chain returns)
_META_SHA = "__sha256__"
_META_SEQ = "__seq__"
_META_PATHS = "__leafpaths__"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file is torn, truncated, or fails checksum verification
    (and, for a lineage, no older entry is valid either)."""


def resolve_path(path: str) -> str:
    """The path normalization shared by save and load: ``.npz`` appended
    when missing."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def manifest_path(path: str) -> str:
    return resolve_path(path)[:-len(".npz")] + ".manifest.json"


# ------------------------------------------------------ JAX's tree paths

def _is_node(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _walk(tree: Any, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{prefix}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, f"{prefix}[{i}]", out)
    elif _is_node(tree):
        for f in dataclasses.fields(tree):
            _walk(getattr(tree, f.name), f"{prefix}.{f.name}", out)
    else:
        out.append((prefix, tree))


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` of every leaf of an operator state, in the order
    and with the paths ``jax.tree_util.tree_flatten_with_path`` gives the
    JAX package's state of the same operator."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def leaf_paths(states) -> Dict[str, list]:
    """``{"op<i>": [keystr, ...]}`` of every state leaf, in flatten order."""
    return {f"op{i}": [p for p, _ in flatten_with_paths(st)]
            for i, st in enumerate(states)}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu().numpy(), copy=True)
    return np.asarray(leaf)


def _flatten(states) -> Dict[str, np.ndarray]:
    return {f"op{i}_leaf{j}": _host(leaf)
            for i, st in enumerate(states)
            for j, (_p, leaf) in enumerate(flatten_with_paths(st))}


def _rebuild(tree: Any, prefix: str, pick) -> Any:
    """``tree``'s structure (its own container order) with each leaf
    replaced by ``pick(path, leaf)``; every container a new object."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}[{k!r}]", pick) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, f"{prefix}[{i}]", pick) for i, v in enumerate(tree))
    if _is_node(tree):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name),
                                                             f"{prefix}.{f.name}", pick)
                                            for f in dataclasses.fields(tree)})
    return pick(prefix, tree)


def _restored(arr: np.ndarray, template, where: str):
    """A saved array as a fresh leaf like ``template`` (its device)."""
    if not isinstance(template, torch.Tensor):
        return arr
    t = torch.from_numpy(np.array(arr, copy=True))
    if tuple(t.shape) != tuple(template.shape) or t.dtype != template.dtype:
        raise KeyError(f"{where}: saved {t.dtype} {tuple(t.shape)} does not fit the "
                       f"chain's {template.dtype} {tuple(template.shape)} — mismatched "
                       f"chain")
    return t.to(template.device)


def _fresh(leaf):
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


# ------------------------------------------------------------- the files

def _digest_map(arrays: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Per-array sha256 (dtype, shape, bytes)."""
    out = {}
    for k in sorted(arrays):
        h = hashlib.sha256()
        a = np.ascontiguousarray(arrays[k])
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
        out[k] = h.hexdigest()
    return out


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_npz_bytes(arrays: Dict[str, np.ndarray], meta: dict) -> bytes:
    """The file's bytes, serialized once: the same bytes feed the atomic write
    and the manifest's whole-file sha256."""
    out = dict(arrays)
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


def _atomic_write(path: str, raw, mode: str = "wb") -> None:
    """Write to a temp file in the target directory, then ``os.replace``:
    readers see the old file or the new one, never a torn one."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            if callable(raw):
                raw(f)
            else:
                f.write(raw)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _write_torn(path: str, raw: bytes, spec) -> None:
    """Injected torn write: half the bytes under the real name, then raise."""
    with open(path, "wb") as f:
        f.write(raw[:max(1, len(raw) // 2)])
    raise _faults.InjectedFault(spec.message or f"injected torn checkpoint write at {path}")


def _read_manifest(mpath: str) -> Optional[dict]:
    try:
        with open(mpath) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None      # a torn manifest degrades to single-file behaviour


def _write_manifest(mpath: str, man: dict) -> None:
    _atomic_write(mpath, lambda f: json.dump(man, f, indent=1), "w")


# ----------------------------------------------------------------- save

def save_chain(chain, path: str, *, meta: dict = None, keep: int = 1) -> str:
    """Snapshot ``chain.states`` (and ``meta``) to ``path`` atomically;
    returns the file written. ``keep > 1`` is lineage mode: each save writes
    ``<stem>.<seq>.npz`` and updates ``<stem>.manifest.json``."""
    return save_states(chain.states, path, meta=meta, keep=keep)


def save_states(states, path: str, *, meta: dict = None, keep: int = 1) -> str:
    """The states-level core of :func:`save_chain`."""
    path = resolve_path(path)
    arrays = _flatten(states)
    full_meta = dict(meta or {})
    full_meta[_META_SHA] = _digest_map(arrays)
    full_meta[_META_PATHS] = leaf_paths(states)
    spec = _faults.decision("checkpoint.save", path=path)
    if keep <= 1:
        raw = _to_npz_bytes(arrays, full_meta)
        if spec is not None:
            if spec.kind == "torn":
                _write_torn(path, raw, spec)
            raise _faults.InjectedFault(
                spec.message or f"injected checkpoint.save fault at {path}")
        _atomic_write(path, raw)
        _faults.bump("checkpoint_saves")
        return path
    # -- lineage mode ------------------------------------------------------------
    mpath = manifest_path(path)
    man = _read_manifest(mpath) or {"version": 1, "stem": os.path.basename(path),
                                    "entries": []}
    entries = man["entries"]
    seq = (entries[-1]["seq"] + 1) if entries else 0
    full_meta[_META_SEQ] = seq
    file = f"{path[:-len('.npz')]}.{seq:06d}.npz"
    raw = _to_npz_bytes(arrays, full_meta)
    if spec is not None:
        if spec.kind == "torn":
            # crash mid-write: the torn file exists but never reaches the manifest
            _write_torn(file, raw, spec)
        raise _faults.InjectedFault(
            spec.message or f"injected checkpoint.save fault at {file}")
    _atomic_write(file, raw)
    entries.append({"file": os.path.basename(file), "seq": seq,
                    "sha256": hashlib.sha256(raw).hexdigest(),
                    # lineage metadata only, never read back
                    "wall": time.time(),
                    "meta": dict(meta or {})})
    while len(entries) > keep:
        old = entries.pop(0)
        try:
            os.unlink(os.path.join(os.path.dirname(path) or ".", old["file"]))
        except OSError:
            pass
    _write_manifest(mpath, man)
    _faults.bump("checkpoint_saves")
    return file


# ----------------------------------------------------------------- load

def _load_states_file(states, path: str, expect_file_sha: Optional[str] = None):
    """Verify one checkpoint file against a template ``states`` list and
    return ``(new_states, user_meta)``."""
    if expect_file_sha is not None and _file_sha256(path) != expect_file_sha:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} fails its manifest sha256 — torn or corrupt")
    try:
        data = np.load(path)
        present = set(data.files)
    except Exception as e:                 # noqa: BLE001 — a torn zip/npz
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is unreadable ({type(e).__name__}: {e})") from e
    try:
        raw = data["__meta__"] if "__meta__" in present else None
        meta = json.loads(bytes(raw).decode()) if raw is not None else {}
        sha_map = meta.pop(_META_SHA, None)
        paths_map = meta.pop(_META_PATHS, None)
        meta.pop(_META_SEQ, None)
        arrays = {k: data[k] for k in present - {"__meta__"}}
    except Exception as e:                 # noqa: BLE001 — a torn member
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is unreadable ({type(e).__name__}: {e})") from e
    if sha_map:
        for k in sorted(arrays):
            want = sha_map.get(k)
            if want is not None and _digest_map({k: arrays[k]})[k] != want:
                raise CheckpointCorrupt(
                    f"checkpoint {path!r}: array {k} fails its sha256 — corrupt data, "
                    f"refusing a silent partial restore")
    tiers = sorted(k for k in arrays if k.startswith("tier"))
    if tiers:
        raise NotImplementedError(
            f"checkpoint {path!r} carries tiered-state manifests ({tiers[0]}, ...): "
            f"tiered keyed state is not ported yet (ROADMAP Queue 1 item 13)")
    new_states = []
    for i, st in enumerate(states):
        cur = flatten_with_paths(st)
        saved_paths = (paths_map or {}).get(f"op{i}")
        if saved_paths is not None:
            # match leaves BY PATH; a missing TRAILING run of saved arrays is
            # the legacy grown-field case, a gap is a mismatched file
            idx = {p: j for j, p in enumerate(saved_paths)}
            have = [f"op{i}_leaf{j}" in present for j in range(len(saved_paths))]
            n_present = sum(have)
            if have[n_present:] != [False] * (len(saved_paths) - n_present):
                j_bad = have.index(False)
                raise KeyError(
                    f"checkpoint {path!r} is missing op{i}_leaf{j_bad} "
                    f"({saved_paths[j_bad]}) but has later leaves of op{i} — "
                    f"mismatched chain or truncated file")

            def pick(p, leaf, i=i, idx=idx, have=have):
                j = idx.get(p)
                if j is None or not have[j]:
                    return _fresh(leaf)
                return _restored(arrays[f"op{i}_leaf{j}"], leaf, f"{path}: op{i}{p}")
        else:
            # no path map: positional restore, trailing-leaf tolerance only
            have = [f"op{i}_leaf{j}" in present for j in range(len(cur))]
            n_present = sum(have)
            if cur and n_present == 0:
                raise KeyError(
                    f"checkpoint {path!r} has no op{i}_leaf* keys for a stateful "
                    f"operator — mismatched chain or truncated file")
            if have[n_present:] != [False] * (len(cur) - n_present):
                j_bad = have.index(False)
                raise KeyError(
                    f"checkpoint {path!r} is missing op{i}_leaf{j_bad} but has later "
                    f"leaves of op{i} — mismatched chain or truncated file")
            pos = {p: j for j, (p, _leaf) in enumerate(cur)}

            def pick(p, leaf, i=i, pos=pos, have=have):
                j = pos[p]
                if not have[j]:
                    return _fresh(leaf)
                return _restored(arrays[f"op{i}_leaf{j}"], leaf, f"{path}: op{i}{p}")
        new_states.append(_rebuild(st, "", pick))
    return new_states, meta


def _walk_lineage(path: str, restore_one):
    """The newest-valid-entry fallback shared by :func:`load_chain` and
    :func:`load_states`: fire ``checkpoint.load``, then try the manifest's
    entries newest to oldest (or ``path`` itself without a manifest)."""
    path = resolve_path(path)
    _faults.fire("checkpoint.load", path=path)
    man = _read_manifest(manifest_path(path))
    if man and man.get("entries"):
        d = os.path.dirname(path) or "."
        last_err: Optional[Exception] = None
        skipped = []
        for ent in reversed(man["entries"]):
            f = os.path.join(d, ent["file"])
            try:
                result = restore_one(f, ent.get("sha256"))
            except (CheckpointCorrupt, KeyError, OSError) as e:
                last_err = e
                skipped.append(ent["file"])
                _faults.bump("checkpoint_corrupt_skipped")
                _journal.record("checkpoint_invalid", path=f, error=type(e).__name__)
                continue
            if skipped:
                _faults.bump("checkpoint_fallbacks")
                _journal.record("checkpoint_fallback", restored=ent["file"],
                                skipped=skipped)
            return result
        raise CheckpointCorrupt(
            f"no valid checkpoint in lineage {path!r} "
            f"({len(man['entries'])} entries, all torn/corrupt)") from last_err
    return restore_one(path, None)


def load_states(states, path: str) -> tuple:
    """States-level :func:`load_chain`: restore against a template states
    list, returning ``(new_states, meta)``."""
    return _walk_lineage(path, lambda f, sha: _load_states_file(states, f,
                                                                expect_file_sha=sha))


def load_chain(chain, path: str) -> dict:
    """Restore ``chain.states`` from ``path``; returns the saved metadata.
    With a lineage manifest the newest valid entry is restored (a torn or
    corrupt latest file falls back to the previous commit); without one an
    invalid file raises :class:`CheckpointCorrupt` (``KeyError`` for a
    chain mismatch)."""
    def restore_one(f, sha):
        new_states, meta = _load_states_file(chain.states, f, expect_file_sha=sha)
        chain.states = new_states
        return meta
    return _walk_lineage(path, restore_one)


# ------------------------------------------------ not ported: sharding

def _refuse_sharded(what: str):
    raise NotImplementedError(f"{what}: sharded checkpoints and the re-sharding "
                              f"handoffs are not ported yet (ROADMAP Queue 1 item 14)")


def save_sharded(shard_states, path: str, **kw):
    _refuse_sharded("save_sharded")


def load_sharded(template_states, path: str):
    _refuse_sharded("load_sharded")


def seal_handoff(shard_states, path: str, **kw):
    _refuse_sharded("seal_handoff")


def discard_handoffs(path: str):
    _refuse_sharded("discard_handoffs")


__all__ = ["CheckpointCorrupt", "resolve_path", "manifest_path", "flatten_with_paths",
           "leaf_paths", "save_chain", "save_states", "load_chain", "load_states",
           "save_sharded", "load_sharded", "seal_handoff", "discard_handoffs"]

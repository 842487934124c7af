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
  raises) and ``checkpoint.load`` fault sites of ``runtime/faults.py``;
- tiered keyed state: :func:`save_chain` settles the chain's tiered
  operators first, then stores each cold tier's manifest as
  ``tier<op>_<ctl>_<name>`` arrays beside the state leaves (covered by the
  same per-array sha256); :func:`load_chain` restores them. A file without
  leaf paths cannot restore into a tiered operator (the tier fields
  interleave into the flatten order, so a positional restore would
  misassign them): it raises ``KeyError``, as the JAX package does.

A restored state is made of fresh tensors on the chain's device (no alias of
the template: Win_Seq updates its rings in place and marks a consumed state).
A chain with captured graphs copies the restored state into the graphs'
static state at its next replay (``runtime/graphs.py``).

Sharded checkpoints (the shard-local supervisors' spills): each shard
writes its own file or lineage under ``<stem>.shard<k>``
(:func:`save_sharded`, fanned out over a thread pool), committed by an atomic
``<stem>.shards.json`` manifest written last; :func:`load_sharded` restores
each shard against a template, with the per-shard lineage fallback. Live
re-sharding seals every retiring shard's state to ``<stem>.handoff<k>.npz``
(:func:`seal_handoff`, the ``reshard.handoff`` fault site) and drops the
seals after the new layout's commit or on a restore
(:func:`discard_handoffs`). All in the JAX package's files, so each package
loads the other's.

A skipped lineage entry and a fallback are counted in the recovery counters
and journaled (``checkpoint_invalid``, ``checkpoint_fallback``), as the JAX
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

from ..batch import flatten_with_paths, is_node
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
    if is_node(tree):
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
    ``<stem>.<seq>.npz`` and updates ``<stem>.manifest.json``. Tiered
    operators settle first and their cold tiers ride as ``tier*`` arrays."""
    chain.tier_settle()
    return save_states(chain.states, path, meta=meta, keep=keep,
                       extra_arrays=chain.tier_manifests())


def save_states(states, path: str, *, meta: dict = None, keep: int = 1,
                extra_arrays: Optional[Dict[str, np.ndarray]] = None) -> str:
    """The states-level core of :func:`save_chain` (``extra_arrays``: the
    cold tiers' ``tier*`` arrays)."""
    path = resolve_path(path)
    arrays = _flatten(states)
    arrays.update(extra_arrays or {})
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

def _load_states_file(states, path: str, expect_file_sha: Optional[str] = None,
                      tier_ops=()):
    """Verify one checkpoint file against a template ``states`` list and
    return ``(new_states, user_meta, extra_arrays)``: ``extra_arrays`` every
    array that is not a state leaf (the cold tiers' ``tier*`` manifests).
    ``tier_ops``: the operator positions whose state is tiered."""
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
            # no path map: positional restore, trailing-leaf tolerance only;
            # refused for a tiered operator, whose tier fields interleave into
            # the flatten order
            if i in tier_ops:
                raise KeyError(
                    f"checkpoint {path!r} predates leaf-path metadata and op{i} has "
                    f"tiered state — a positional restore would misassign fields; "
                    f"re-save the checkpoint (or restore into an untiered chain first)")
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
    extra = {k: v for k, v in arrays.items() if not k.startswith("op")}
    return new_states, meta, extra


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
    return _walk_lineage(path, lambda f, sha: _load_states_file(
        states, f, expect_file_sha=sha)[:2])


def load_chain(chain, path: str) -> dict:
    """Restore ``chain.states`` from ``path``; returns the saved metadata.
    With a lineage manifest the newest valid entry is restored (a torn or
    corrupt latest file falls back to the previous commit); without one an
    invalid file raises :class:`CheckpointCorrupt` (``KeyError`` for a
    chain mismatch)."""
    def restore_one(f, sha):
        new_states, meta, extra = _load_states_file(chain.states, f, expect_file_sha=sha,
                                                    tier_ops=chain._tier_ops)
        chain.states = new_states
        # the cold tiers from the tier* arrays; a file written before the
        # operator was tiered has none: the store stands, copies in flight
        # are discarded either way
        chain.tier_restore_manifests({k: v for k, v in extra.items()
                                      if k.startswith("tier")})
        return meta
    return _walk_lineage(path, restore_one)


# ------------------------------------------------------- sharded checkpoints

#: shards-manifest schema version (the JAX package's)
_SHARDS_VERSION = 1


def shard_stem(path: str, shard: int) -> str:
    """File stem of one shard's checkpoint (its own atomic-write and lineage
    namespace): ``<stem>.shard<k>`` beside the unsharded ``<stem>.npz``."""
    return resolve_path(path)[:-len(".npz")] + f".shard{int(shard)}"


def shards_manifest_path(path: str, shard_ids=None) -> str:
    """The sharded-checkpoint manifest: ``<stem>.shards.json`` for a save of
    every shard, ``<stem>.shards.s<lo>-<hi>.json`` for a slice (so hosts
    sharing a file system never overwrite each other's)."""
    stem = resolve_path(path)[:-len(".npz")]
    if shard_ids is None:
        return stem + ".shards.json"
    ids = sorted(int(i) for i in shard_ids)
    return stem + f".shards.s{ids[0]}-{ids[-1]}.json"


def save_sharded(shard_states, path: str, *, layout: dict, meta: dict = None,
                 keep: int = 1, parallel: bool = True, shard_ids=None) -> dict:
    """One file (or ``keep`` lineage) a shard through :func:`save_states`,
    fanned out over a thread pool, committed by the shards manifest written
    last: a reader only sees shard files a whole manifest names, so a crash
    mid-fan-out leaves the previous sharded commit. ``layout`` is the
    ``ShardAssignment.to_meta()`` the restore re-derives ownership from.
    Returns the manifest written."""
    shard_states = list(shard_states)
    ids = (list(range(len(shard_states))) if shard_ids is None
           else [int(i) for i in shard_ids])
    n = int(layout.get("num_shards", len(shard_states)))
    meta = dict(meta or {})

    def save_one(j):
        return save_states(shard_states[j], shard_stem(path, ids[j]),
                           meta={**meta, "shard": ids[j], "num_shards": n}, keep=keep)
    if parallel and len(ids) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(len(ids), 8)) as ex:
            files = list(ex.map(save_one, range(len(ids))))
    else:
        files = [save_one(j) for j in range(len(ids))]
    man = {"version": _SHARDS_VERSION, "num_shards": n, "layout": dict(layout),
           "meta": meta,
           "shards": [{"shard": k, "file": os.path.basename(f)} for k, f in zip(ids, files)]}
    full = ids == list(range(n))
    _write_manifest(shards_manifest_path(path, None if full else ids), man)
    return man


def load_sharded(template_states, path: str) -> tuple:
    """Restore a :func:`save_sharded` checkpoint against ``template_states``
    (fresh per-operator states): every ``<stem>.shards*.json`` manifest is
    read, the newest generation naming a shard wins, and each shard restores
    the file its manifest names (its own lineage on a torn file). Returns
    ``({shard: states}, layout, meta)``; raises :class:`CheckpointCorrupt`
    when no manifest exists, manifests disagree on the layout, a shard is
    missing, or a shard is ahead of its manifest."""
    import glob
    stem = resolve_path(path)[:-len(".npz")]
    mans = []
    for mp_ in sorted(glob.glob(stem + ".shards*.json")):
        man = _read_manifest(mp_)
        if man and "num_shards" in man:
            mans.append(man)
    if not mans:
        raise CheckpointCorrupt(
            f"no sharded-checkpoint manifest at {shards_manifest_path(path)!r} (or any "
            f"per-slice {os.path.basename(stem)}.shards.s*-*.json beside it)")
    n = int(mans[0]["num_shards"])
    layout = dict(mans[0].get("layout", {}))
    for man in mans[1:]:
        if int(man["num_shards"]) != n or dict(man.get("layout", {})) != layout:
            raise CheckpointCorrupt(
                f"sharded-checkpoint manifests under {stem!r} disagree on the layout "
                f"epoch — mixed-generation slices; clear the stale manifests and re-save")

    def generation(m):
        b = m.get("meta", {}).get("batches_done")
        return -(b if isinstance(b, int) else -1)
    mans.sort(key=generation)
    entries = {}
    for man in mans:
        for ent in man.get("shards", []):
            entries.setdefault(int(ent["shard"]), (ent, dict(man.get("meta", {}))))
    missing = sorted(set(range(n)) - set(entries))
    if missing:
        raise CheckpointCorrupt(
            f"sharded checkpoint {stem!r} covers only shards {sorted(entries)} of {n} — "
            f"shard(s) {missing} missing (a host's slice never committed); refusing a "
            f"silent partial restore")
    d = os.path.dirname(resolve_path(path)) or "."
    out, shard_meta = {}, {}
    for k in sorted(entries):
        ent, man_meta = entries[k]
        # the manifest-named file is the commit; only a torn one falls back
        # to the shard's own lineage
        try:
            states, meta_k, _extra = _load_states_file(template_states,
                                                       os.path.join(d, ent["file"]))
        except (CheckpointCorrupt, KeyError, OSError):
            states, meta_k = load_states(template_states, shard_stem(path, k))
        meta_k = {kk: v for kk, v in meta_k.items() if kk not in ("shard", "num_shards")}
        if (meta_k.get("batches_done") is not None
                and man_meta.get("batches_done") is not None
                and meta_k["batches_done"] > man_meta["batches_done"]):
            raise CheckpointCorrupt(
                f"sharded checkpoint {stem!r}: shard {k} is at batches_done="
                f"{meta_k['batches_done']}, AHEAD of its manifest "
                f"({man_meta['batches_done']}) — a crash between the shard fan-out and "
                f"the manifest rewrite overwrote the committed generation; save with "
                f"checkpoint_keep >= 2 so the manifest-named lineage entry survives the "
                f"next fan-out")
        out[k] = states
        shard_meta[k] = meta_k
    meta = dict(mans[0].get("meta", {}))
    meta["shard_meta"] = shard_meta
    return out, layout, meta


# ------------------------------------------------- re-sharding handoff seal

def handoff_path(path: str, shard: int) -> str:
    return resolve_path(path)[:-len(".npz")] + f".handoff{int(shard)}.npz"


def seal_handoff(shard_states, path: str, *, layout: dict, at_pos: int) -> list:
    """Phase 1 of the re-sharding handoff: every retiring shard's state
    sealed to ``<stem>.handoff<k>.npz`` (atomic, per-array sha256). Not a
    commit: the shards manifest still names the old layout, so a crash
    before the new layout's first commit leaves only orphan seals for
    :func:`discard_handoffs`."""
    files = []
    for k, states in enumerate(shard_states):
        spec = _faults.decision("reshard.handoff", shard=k, at_pos=at_pos)
        f = handoff_path(path, k)
        arrays = _flatten(states)
        hmeta = {"layout": dict(layout), "at_pos": int(at_pos), "shard": k,
                 _META_SHA: _digest_map(arrays), _META_PATHS: leaf_paths(states)}
        raw = _to_npz_bytes(arrays, hmeta)
        if spec is not None:
            if spec.kind == "torn":
                _write_torn(f, raw, spec)
            raise _faults.InjectedFault(
                spec.message or f"injected reshard.handoff fault at {f}")
        _atomic_write(f, raw)
        files.append(f)
    return files


def discard_handoffs(path: str) -> list:
    """Drop every handoff seal under ``path`` (a restore mid-handoff: replay
    re-derives the move at the same barrier). Returns the file names."""
    import glob
    stem = resolve_path(path)[:-len(".npz")]
    dropped = []
    for f in sorted(glob.glob(stem + ".handoff*.npz")):
        try:
            os.unlink(f)
            dropped.append(os.path.basename(f))
        except OSError:
            pass
    return dropped


__all__ = ["CheckpointCorrupt", "resolve_path", "manifest_path", "flatten_with_paths",
           "leaf_paths", "save_chain", "save_states", "load_chain", "load_states",
           "shard_stem", "shards_manifest_path", "save_sharded", "load_sharded",
           "handoff_path", "seal_handoff", "discard_handoffs"]

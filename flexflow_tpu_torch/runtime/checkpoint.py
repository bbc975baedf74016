"""Checkpoint and resume of a model's weights, optimizer state and op
state (the port's copy of flexflow_tpu/runtime/checkpoint.py, with THE
SAME FILE FORMAT, so a checkpoint written by either package restores into
the other).

A checkpoint is an npz of '/'-joined keys: `params/<op>/<weight>`,
`opt_state/step`, `opt_state/lr`, `opt_state/<m|v>/<op>/<weight>` and
`state/<op>/<var>`, beside a `__meta__` JSON record (format name and
version, step, step_count, the true dtype of each array stored widened,
and a CRC32 of each array's stored bytes). A bf16 tensor is stored as
f32 and recorded as "bfloat16" in `dtypes` (torch's `.float()`: numpy has
no bf16 without the JAX package's ml_dtypes); on restore each value is
converted to the receiving model's own dtype. Writes are atomic: a temp
file in the same directory, fsync, rename over the final name, then an
fsync of the directory.

Restore is IN PLACE. Every array is read and checked against its CRC32,
and every name and shape of the three groups against the model, before
anything is written; then the values go through `load_params`,
`load_opt_state` and `load_state` (copies into the existing tensors) and
`_step_count` is set. No weight or optimizer tensor is rebound: a
captured K-step graph (runtime/executor.py `MultiStep`) keeps reading the
same addresses, and the serving graphs (runtime/graphs.py) re-capture on
the version bump the copies make.

On a mesh `save_checkpoint` gathers the weights and moments over `model`
(every rank of the mesh calls it), the mesh's leader (the rank at
position 0, `Mesh.leader`) writes, and the ranks meet at a barrier of
the mesh's own group (`Mesh.group_all`: a rank outside the mesh, or one
lost to the elastic coordinator, takes no part); a mesh-less model
compiled on several ranks holds a whole copy on each, and the first of
them writes (`holders`);
`restore_checkpoint` reads the file on every rank, which keeps its
shards. On a `stage` axis the pipelined region's weights and moments are
stored as the JAX package stores them: stacked over the stages under
`__pipeline__/seg{j}_op{r}_{name}/{w}` (JAX `executor.py _pp_key`: r-th
op of the stage-0 template segment j, leading dim the stage), which
`_stack` builds from the gathered per-op tree and `_unstack` takes back
into each stage's ops, as `model.params_from_jax` does. Retention,
manifests and the verified fallback live in runtime/durability.py.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict

import numpy as np
import torch

FORMAT_NAME = "flexflow_tpu_checkpoint"
FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, torn, corrupt, not a checkpoint, or
    does not fit the model. The message names the path."""


def _host(v) -> np.ndarray:
    """A value as the numpy array it is stored as: a tensor on the host,
    bf16 widened to f32."""
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """'/'-joined keys of a nested dict's leaves."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    """fsync the containing directory so the rename itself is durable."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # platforms / filesystems without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _mesh(model):
    return getattr(model, "mesh", None)


def _whole(model, tree):
    """A weight-shaped tree whole: gathered over `model` on a mesh."""
    return tree if _mesh(model) is None else model.gather_params(tree)


def _pipeline_plan(model):
    return getattr(getattr(model, "executor", None), "pipeline_plan", None)


def _stack(model, tree):
    """A whole weight-shaped tree in the file's layout: on a `stage` axis
    the pipelined ops' entries stacked over the stages under
    `__pipeline__` (JAX `_init_pipeline_params`), the others as they
    are."""
    plan = _pipeline_plan(model)
    if plan is None:
        return tree
    k = plan.segs_per_stage
    region = {op.name for group in plan.segments for op in group}
    out = {op: ws for op, ws in tree.items() if op not in region}
    stacked = {}
    for j in range(k):
        for r, template in enumerate(plan.segments[j]):
            if not template.specs:
                continue
            stacked[f"seg{j}_op{r}_{template.name}"] = {
                ws.name: torch.stack([
                    tree[plan.segments[s * k + j][r].name][ws.name]
                    for s in range(plan.n_stages)])
                for ws in template.specs}
    out["__pipeline__"] = stacked
    return out


def _unstack(model, tree):
    """The inverse of `_stack`: each stacked entry's slices back under
    the names of every stage's ops. Entries it does not know stay, for
    the name check to report."""
    plan = _pipeline_plan(model)
    if plan is None or "__pipeline__" not in tree:
        return tree
    out = {op: ws for op, ws in tree.items() if op != "__pipeline__"}
    stacked = dict(tree["__pipeline__"])
    k = plan.segs_per_stage
    for j in range(k):
        for r, template in enumerate(plan.segments[j]):
            entry = stacked.pop(f"seg{j}_op{r}_{template.name}", None)
            for w, stack in (entry or {}).items():
                for s in range(plan.n_stages):
                    name = plan.segments[s * k + j][r].name
                    out.setdefault(name, {})[w] = stack[s]
    if stacked:
        out["__pipeline__"] = stacked
    return out


def holders(model):
    """(leader, group) of the ranks that hold `model`'s state and meet
    when its checkpoint is written: the mesh's (`Mesh.leader`,
    `Mesh.group_all`); for a mesh-less model compiled on several ranks
    (FFModel.live_ranks), each holding a whole copy, the first of them
    and their group; None for a model of one process."""
    mesh = _mesh(model)
    if mesh is not None:
        return mesh.leader, mesh.group_all
    live = getattr(model, "live_ranks", None)
    if live and len(live) > 1:
        from . import distributed

        return live[0], distributed.group_of(live)
    return None


def _writes(model) -> bool:
    """Whether this rank writes `model`'s checkpoints: the holders'
    leader, or the one process."""
    held = holders(model)
    return held is None or torch.distributed.get_rank() == held[0]


def save_checkpoint(path: str, model, step: int = 0) -> str:
    """Atomically write weights, optimizer state and op state with their
    metadata and CRC32s. Returns the final path (".npz" appended when
    missing). On a mesh every rank of it calls it and the leader
    writes."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    trees = {"params": _stack(model, _whole(model, model.params or {})),
             "opt_state": {k: _stack(model, _whole(model, v))
                           if isinstance(v, dict) else v
                           for k, v in (model.opt_state or {}).items()},
             "state": model.state or {}}
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for group, tree in trees.items():
        for k, v in _flatten(tree, f"{group}/").items():
            if torch.is_tensor(v) and v.dtype == torch.bfloat16:
                dtypes[k] = "bfloat16"
            flat[k] = _host(v)
    if _writes(model):
        # checksums cover the bytes as STORED (after widening)
        meta = {
            "format": FORMAT_NAME,
            "version": FORMAT_VERSION,
            "step": int(step),
            "step_count": int(model._step_count),
            "dtypes": dtypes,
            "crc32": {k: _crc32(v) for k, v in flat.items()},
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, __meta__=json.dumps(meta), **flat)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _fsync_dir(path)
    held = holders(model)
    if held is not None:
        torch.distributed.barrier(group=held[1])
    return path


def _open_checkpoint(path: str):
    """np.load with the torn / missing / foreign failure modes mapped to
    CheckpointError. Returns (npz, meta)."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    if not os.path.exists(path):
        raise CheckpointError(f"checkpoint {path!r} does not exist")
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as exc:  # BadZipFile / OSError / ValueError ...
        raise CheckpointError(
            f"checkpoint {path!r} is unreadable (torn write or not an "
            f"npz): {type(exc).__name__}: {exc}") from exc
    if "__meta__" not in data.files:
        raise CheckpointError(
            f"{path!r} is a valid npz but not a flexflow_tpu checkpoint "
            "(no __meta__ record); checkpoints are written by "
            "save_checkpoint")
    try:
        meta = json.loads(str(data["__meta__"]))
    except Exception as exc:
        raise CheckpointError(
            f"checkpoint {path!r} has an unparseable __meta__ record: "
            f"{exc}") from exc
    return data, meta


def _read(data, path: str, key: str, crcs: Dict[str, int]) -> np.ndarray:
    try:
        val = data[key]
    except Exception as exc:  # truncated member / zlib error
        raise CheckpointError(
            f"checkpoint {path!r}: array {key!r} is unreadable (torn "
            f"write): {type(exc).__name__}: {exc}") from exc
    want = crcs.get(key)
    if want is not None and _crc32(val) != want:
        raise CheckpointError(
            f"checkpoint {path!r}: array {key!r} fails its CRC32 check "
            "(corrupt on disk)")
    return val


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint whole and check every array against its CRC32.
    Returns the metadata; raises CheckpointError naming the path (and the
    first bad array) otherwise. A checkpoint without CRCs verifies by
    being readable."""
    data, meta = _open_checkpoint(path)
    crcs = meta.get("crc32", {})
    for key in data.files:
        if key != "__meta__":
            _read(data, path, key, crcs)
    return meta


def _check_tree(path: str, group: str, got: Dict[str, np.ndarray],
                want: Dict[str, Any]) -> None:
    """Every name and shape of `got` (flat keys) against `want` (the
    model's tree, flattened the same way)."""
    mine = _flatten(want)
    if set(got) != set(mine):
        missing = sorted(set(mine) - set(got))[:5]
        extra = sorted(set(got) - set(mine))[:5]
        raise CheckpointError(
            f"checkpoint {path!r}: {group} names differ from the model's "
            f"(missing {missing}, unknown {extra})")
    for k, v in got.items():
        if tuple(np.shape(v)) != tuple(mine[k]):
            raise CheckpointError(
                f"checkpoint {path!r}: {group}/{k} has shape "
                f"{tuple(np.shape(v))}, the model's is {tuple(mine[k])}")


def _whole_shapes(model) -> Dict[str, Any]:
    """Each group's tree of the model's whole shapes (a mesh rank holds
    shards of the weights and moments; on a `stage` axis, only its own
    stage's ops, and the check covers every stage's)."""
    specs = {op.name: {ws.name: ws.dims for ws in op.specs}
             for op in getattr(model, "ops", ())}
    every = ({op.name: {ws.name: None for ws in op.specs}
              for op in model.ops if op.specs}
             if _pipeline_plan(model) is not None else None)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    def whole(tree):
        tree = every if every is not None else tree
        return {op: {w: specs.get(op, {}).get(w) or tuple(t.shape)
                     for w, t in ws.items()} for op, ws in tree.items()}

    return {"params": whole(model.params or {}),
            "opt_state": {k: whole(v) if isinstance(v, dict)
                          else tuple(v.shape)
                          for k, v in (model.opt_state or {}).items()},
            "state": shapes(model.state or {})}


def restore_checkpoint(path: str, model, verify: bool = True) -> int:
    """Load a checkpoint into the model in place; returns its step.

    With verify=True every array is checked against its CRC32 in the same
    pass that reads it; every array is read and every name and shape of
    the three groups checked against the model BEFORE anything is
    written, so a corrupt or foreign file raises CheckpointError and
    leaves the model as it was. A group the file lacks is left as it is,
    and a model compiled for inference, which holds no optimizer state,
    takes none."""
    data, meta = _open_checkpoint(path)
    crcs = meta.get("crc32", {}) if verify else {}
    groups: Dict[str, Dict[str, np.ndarray]] = {
        "params": {}, "opt_state": {}, "state": {}}
    for key in data.files:
        if key == "__meta__":
            continue
        val = _read(data, path, key, crcs)
        head, _, rest = key.partition("/")
        if head not in groups:
            raise CheckpointError(
                f"checkpoint {path!r}: unexpected top-level key {key!r}")
        groups[head][rest] = val
    shapes = _whole_shapes(model)
    if model.opt_state is None:
        groups["opt_state"] = {}
    tensors = {g: _unflatten({k: torch.from_numpy(np.asarray(v))
                              for k, v in got.items()})
               for g, got in groups.items()}
    tensors["params"] = _unstack(model, tensors["params"])
    tensors["opt_state"] = {k: _unstack(model, v) if isinstance(v, dict)
                            else v for k, v in tensors["opt_state"].items()}
    for group in groups:
        if groups[group]:  # a group the file lacks stays as it is (JAX's)
            _check_tree(path, group, _flatten(tensors[group]),
                        shapes[group])
    if _pipeline_plan(model) is not None:
        # a stage rank's optimizer holds its own stage's moments only
        tensors["opt_state"] = {
            k: {op: ws for op, ws in v.items() if op in model.opt_state[k]}
            if isinstance(v, dict) else v
            for k, v in tensors["opt_state"].items()}
    if groups["params"]:
        model.load_params(tensors["params"])
    if groups["opt_state"]:
        model.load_opt_state(tensors["opt_state"])
    if groups["state"]:
        model.load_state(tensors["state"])
    model._step_count = int(meta.get("step_count", 0))
    return int(meta["step"])

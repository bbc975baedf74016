"""ctypes binding to the port's native host core, libffcore (counterpart
of flexflow_tpu/native/__init__.py).

The core is C++ with a C ABI: the graph algorithms (topological order,
post-dominator bottlenecks), the analytic machine model, the Unity search
over (dp, tp, sp, ep, ap, row tp) with MCMC refinement, the prefetching
batch loader behind `BatchStream`, and the model-building C API that C
programs link (examples/c/mlp.c; `c_model.model_from_spec` loads what
they export). Python feeds the search a line protocol
(`serialize_graph`).

The sources are the port's own copy, `flexflow_tpu_torch/csrc/ffcore/`.
At first use (never at import) g++ compiles them with the flags of the
JAX package's src/ffcore/Makefile into `flexflow_tpu_torch/_build/`
(ignored by git), under a name keyed by the hash of the sources and
flags, while an exclusive lock on `_build/ffcore.lock` is held: processes
that share the checkout (pytest workers, a mesh's ranks) never write the
same file, and a second one loads what the first built. If the build or
the load fails, `available()` is False, one warning carries the
compiler's or the loader's error, and the callers take the Python search
and the numpy loader, as the JAX package's do.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc" / "ffcore"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("graph.cc", "machine.cc", "search.cc", "capi.cc", "model_c.cc",
           "dataloader.cc")
HEADERS = ("ffcore.h",)
CXX = "g++"
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall"]
LDFLAGS = ["-shared", "-lpthread"]

_log = logging.getLogger("flexflow_tpu_torch.native")
_lock = threading.Lock()
_lib = None
_load_error: Optional[str] = None
# what the build did: library path, whether it compiled, seconds
BUILD_INFO: Dict[str, object] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join([CXX] + CXXFLAGS + LDFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources and flags lands."""
    return BUILD_DIR / f"libffcore_{_digest()}.so"


def _compile(lib_path: Path) -> None:
    """Compile every source (in parallel) into a temporary directory under
    _build/, link into a temporary name, then rename into place."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR,
                                     prefix=".ffcore_") as tmp:
        jobs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cc", ".o"))
            jobs.append((name, obj, subprocess.Popen(
                [CXX, *CXXFLAGS, "-c", str(SRC_DIR / name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for name, _, proc in jobs:  # wait for every compile before raising
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"{CXX} failed on " + ", ".join(failed)
                               + ":\n" + "\n".join(logs[n] for n in failed))
        out = os.path.join(tmp, lib_path.name)
        link = subprocess.run(
            [CXX, "-o", out, *[obj for _, obj, _ in jobs], *LDFLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking libffcore failed:\n{link.stdout}")
        os.replace(out, lib_path)
    BUILD_INFO.update(compiled=True, library=str(lib_path),
                      seconds=time.perf_counter() - t0)


def _found(lib_path: Path) -> bool:
    """The library exists; noted as found unless this process built it."""
    if not lib_path.exists():
        return False
    if BUILD_INFO.get("library") != str(lib_path):
        BUILD_INFO.update(compiled=False, library=str(lib_path), seconds=0.0)
    return True


def _build() -> Path:
    lib_path = library_path()
    if _found(lib_path):
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "ffcore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if _found(lib_path):
            return lib_path
        if shutil.which(CXX) is None:
            raise RuntimeError(f"C++ compiler {CXX!r} not found on PATH: "
                               "libffcore is built from csrc/ffcore at "
                               "first use")
        _compile(lib_path)
    return lib_path


def _fail(what: str, err: BaseException) -> None:
    global _load_error
    _load_error = f"{what}: {err}"
    _log.warning("libffcore unavailable, the Python search and the numpy "
                 "loader take over (%s)", _load_error)


def ensure_built() -> Optional[str]:
    """Build libffcore if the current sources have no library yet. Returns
    its path, or None when the build failed (then `available()` is
    False). Tried once a process."""
    with _lock:
        if _lib is not None:
            return BUILD_INFO.get("library")
        if _load_error is not None:
            return None
        try:
            return str(_build())
        except Exception as e:  # compiler missing or compile error
            _fail("native build failed", e)
            return None


def _load():
    global _lib
    if _lib is not None or _load_error is not None:
        return _lib
    path = ensure_built()
    with _lock:
        if path is None or _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(path)
            lib.ffc_run.argtypes = [ctypes.c_char_p]
            lib.ffc_run.restype = ctypes.c_void_p
            lib.ffc_free.argtypes = [ctypes.c_void_p]
            lib.ffc_version.restype = ctypes.c_char_p
            # the batch loader (csrc/ffcore/dataloader.cc)
            lib.ffdl_create.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.ffdl_create.restype = ctypes.c_void_p
            lib.ffdl_next.argtypes = [ctypes.c_void_p]
            lib.ffdl_next.restype = ctypes.c_void_p
            lib.ffdl_epoch.argtypes = [ctypes.c_void_p]
            lib.ffdl_epoch.restype = ctypes.c_int64
            lib.ffdl_reset.argtypes = [ctypes.c_void_p]
            lib.ffdl_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, AttributeError) as e:
            _fail("loading libffcore failed", e)
    return _lib


def available() -> bool:
    return _load() is not None


def version() -> Optional[str]:
    lib = _load()
    return lib.ffc_version().decode() if lib else None


def load_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    return _load_error


def run(protocol_text: str) -> str:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"libffcore unavailable: {_load_error}")
    ptr = lib.ffc_run(protocol_text.encode())
    try:
        out = ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    finally:
        lib.ffc_free(ptr)
    if out.startswith("error "):
        raise RuntimeError(f"ffcore: {out[6:].strip()}")
    return out


# ---------------------------------------------------------------- protocol
def _tp_divisor(op) -> int:
    from ..ffconst import OpType

    if op.op_type == OpType.LINEAR:
        return int(op.params["out_dim"])
    if op.op_type == OpType.MULTIHEAD_ATTENTION:
        return int(op.params["num_heads"])
    if op.op_type == OpType.EMBEDDING:
        return int(op.params["out_dim"])
    if op.op_type == OpType.BATCHMATMUL:
        return 0  # always divisible
    return -1


def serialize_graph(graph, machine=None, config=None, batch: int = 1,
                    n_devices: int = 1, mcmc_iters: int = 0) -> str:
    """Render the PCG + machine + options into the ffcore line protocol,
    the JAX package's text for the same graph (a bf16 element is 2
    bytes: `DataType.itemsize`)."""
    from ..ffconst import OpType
    from ..search.simulator import (AP_CAPABLE, TP_CAPABLE, ap_halo_elems,
                                    attn_kv_bytes, attn_q_bytes,
                                    attn_sp_ulysses, sp_capability)

    lines: List[str] = []
    if machine is not None:
        c = machine.chip
        link_mult = 2.0 if machine.version() >= 1 else 1.0
        chips_per_pod = getattr(machine, "chips_per_pod", 256)
        channels = 1 if machine.comm_channels() else 0
        lines.append(
            f"machine {machine.num_chips} {c.peak_bf16_tflops} "
            f"{c.peak_f32_tflops} {c.hbm_gb} {c.hbm_bw_gbps} "
            f"{c.ici_link_gbps} {c.dcn_gbps} {link_mult} {chips_per_pod} "
            f"{channels}"
        )
    if config is not None:
        lines.append(
            "options "
            f"{n_devices} {batch} {max(0, config.search_budget)} "
            f"{config.search_alpha} {int(config.only_data_parallel)} "
            f"{int(config.allow_mixed_precision)} "
            f"{int(config.search_overlap_backward_update)} "
            f"{int(config.memory_search)} "
            f"{config.memory_budget_mb * 1e6 if config.memory_search else 0} "
            f"{mcmc_iters} {config.seed} "
            f"{int(config.enable_parameter_parallel)}"
        )
        # sequence-parallel candidates (feasibility is Python-side: op
        # coverage, dropout gate, seq-length/head divisibility)
        from ..search.unity import (feasible_ap_values,
                                    feasible_ep_values,
                                    feasible_sp_values)

        sps = feasible_sp_values(graph, config, n_devices)
        lines.append("sps " + " ".join(str(v) for v in sps))
        # expert-parallel candidates (divisors of every expert count)
        eps = feasible_ep_values(graph, config, n_devices)
        lines.append("eps " + " ".join(str(v) for v in eps))
        # attribute/spatial candidates (--enable-attribute-parallel;
        # per-op H divisibility is checked native-side via the ap fields)
        aps = feasible_ap_values(graph, config, n_devices)
        lines.append("aps " + " ".join(str(v) for v in aps))
    inert_types = (OpType.INPUT, OpType.NOOP, OpType.WEIGHT)
    for op in graph.topo_order():
        weight_bytes = sum(
            w.num_elements() * w.dtype.itemsize for w in op.weights
        )
        act_bytes = sum(
            t.num_elements() * t.dtype.itemsize for t in op.outputs
        )
        out_elems = op.outputs[0].num_elements() if op.outputs else 0
        dtype_bytes = op.outputs[0].dtype.itemsize if op.outputs else 4
        # sp capability + K/V bytes via the SAME helpers the Python cost
        # model uses (simulator.py) — the two cost models cannot drift
        sp_capable = sp_capability(op)
        sp_divisor = op.outputs[0].dims[1] if sp_capable else 0
        el = (2 if (config is not None and config.allow_mixed_precision)
              else (op.outputs[0].dtype.itemsize if op.outputs else 4))
        sp_kv_base = attn_kv_bytes(op, el)
        # expert-parallel fields: capacity-buffer ELEMENT counts via the
        # same helper the Python cost model uses (simulator.py
        # ep_collective_time_us); native multiplies by its effective dtype
        ep_capable = op.op_type == OpType.EXPERTS
        ep_divisor = ep_disp = ep_comb = 0
        if ep_capable:
            from ..ops.moe import moe_capacity

            x = op.inputs[0]
            n_exp = op.params["n"]
            cap = moe_capacity(x.dims[0], op.inputs[2].dims[1], n_exp,
                               op.params.get("alpha", 1.0))
            ep_divisor = n_exp
            ep_disp = n_exp * cap * x.dims[1]
            ep_comb = n_exp * cap * op.params["out_dim"]
        # row-parallel ("parameter"-parallel) linear fields: kernel bytes
        # (the bias stays replicated under row sharding) and the in-feature
        # divisor (unity.py op_strategy_menu tp_row gate)
        row_capable = op.op_type == OpType.LINEAR
        row_divisor = kernel_bytes = 0
        if row_capable:
            row_divisor = op.inputs[0].dims[-1]
            kernel_bytes = sum(
                w.num_elements() * w.dtype.itemsize
                for w in op.weights
                if w._weight_spec.name == "kernel")
        # attribute/spatial fields (simulator.py AP_CAPABLE +
        # ap_halo_time_us; divisibility checked native-side)
        ap_capable = (op.op_type in AP_CAPABLE and op.inputs
                      and len(op.inputs[0].dims) == 4 and op.outputs
                      and len(op.outputs[0].dims) == 4)
        ap_h = ap_out_h = ap_halo = 0
        ap_stride = 1
        if ap_capable:
            ap_h = op.inputs[0].dims[2]
            ap_out_h = op.outputs[0].dims[2]
            ap_stride = max(1, op.params.get("stride_h", 1))
            ap_halo = ap_halo_elems(op)
        lines.append(
            f"node {op.guid} {op.flops()} {op.bytes_accessed()} "
            f"{weight_bytes} {act_bytes} {out_elems} {dtype_bytes} "
            f"{int(op.op_type in TP_CAPABLE)} {_tp_divisor(op)} "
            f"{int(op.op_type in inert_types)} "
            f"{int(sp_capable)} {sp_divisor} {sp_kv_base} "
            f"{int(ep_capable)} {ep_divisor} {ep_disp} {ep_comb} "
            f"{int(ap_capable)} {ap_h} {ap_out_h} {ap_stride} {ap_halo} "
            f"{int(row_capable)} {row_divisor} {kernel_bytes} "
            f"{int(attn_sp_ulysses(op))} {attn_q_bytes(op, el)}"
        )
    for e in graph.edges():
        t = graph.ops[e.src].outputs[e.src_idx]
        bytes_ = t.num_elements() * t.dtype.itemsize
        lines.append(f"edge {e.src} {e.dst} {bytes_}")
    return "\n".join(lines) + "\n"


def topo_order(graph) -> List[int]:
    out = run("cmd topo\n" + serialize_graph(graph))
    return [int(g) for g in out.split()]


def bottlenecks(graph) -> List[int]:
    out = run("cmd bottlenecks\n" + serialize_graph(graph))
    return [int(g) for g in out.split()]


def optimize_strategy(graph, config, machine, batch: int, n_devices: int,
                      mcmc_iters: int = 0):
    """Native Unity search. Returns a search.unity.SearchResult."""
    from ..search.simulator import OpStrategy
    from ..search.unity import SearchResult

    text = "cmd optimize\n" + serialize_graph(
        graph, machine, config, batch, n_devices, mcmc_iters
    )
    out = run(text)
    cost = mem = 0.0
    mesh_dp = mesh_tp = mesh_sp = mesh_ep = mesh_ap = 1
    strategies: Dict[int, OpStrategy] = {}
    log: List[str] = ["native ffcore search"]
    for line in out.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "cost":
            cost = float(parts[1])
        elif parts[0] == "memory":
            mem = float(parts[1])
        elif parts[0] == "mesh":
            mesh_dp, mesh_tp = int(parts[1]), int(parts[2])
            if len(parts) > 3:
                mesh_sp = int(parts[3])
            if len(parts) > 4:
                mesh_ep = int(parts[4])
            if len(parts) > 5:
                mesh_ap = int(parts[5])
        elif parts[0] == "strategy":
            strategies[int(parts[1])] = OpStrategy(
                dp=int(parts[2]), tp=int(parts[3]),
                sp=int(parts[4]) if len(parts) > 4 else 1,
                ep=int(parts[5]) if len(parts) > 5 else 1,
                ap=int(parts[6]) if len(parts) > 6 else 1,
                tp_row=bool(int(parts[7])) if len(parts) > 7 else False,
            )
        elif parts[0] == "log":
            log.append(line[4:])
    if cost < 0 or not strategies:
        # mirror the Python search's behavior (no silent degenerate result)
        raise ValueError("no feasible mesh factorization")
    axes = {}
    if mesh_dp > 1 and any(s.dp > 1 for s in strategies.values()):
        axes["data"] = mesh_dp
    if mesh_tp > 1 and any(s.tp > 1 for s in strategies.values()):
        axes["model"] = mesh_tp
    if mesh_sp > 1 and any(s.sp > 1 for s in strategies.values()):
        axes["seq"] = mesh_sp
    if mesh_ep > 1 and any(s.ep > 1 for s in strategies.values()):
        axes["expert"] = mesh_ep
    if mesh_ap > 1 and any(s.ap > 1 for s in strategies.values()):
        axes["attr"] = mesh_ap
    return SearchResult(strategies, axes, cost, mem, log)


# ------------------------------------------------------------- batch loader
class BatchStream:
    """Native prefetching batch stream over a host numpy array
    (csrc/ffcore/dataloader.cc): a C++ producer thread gathers (optionally
    shuffled, `std::mt19937_64` seeded by seed + epoch) sample rows into a
    ring of contiguous batch buffers ahead of the consumer.

    The array returned by next_batch() is a view of a ring slot, valid
    until the FOLLOWING next_batch() call (`torch.from_numpy(...).to(dev)`
    or `.copy()` takes it out at once in normal use).
    """

    def __init__(self, data, batch_size: int, shuffle: bool = False,
                 seed: int = 0, prefetch_depth: int = 3):
        import numpy as np

        lib = _load()
        if lib is None:
            raise RuntimeError(f"libffcore unavailable: {_load_error}")
        self._lib = lib
        self.data = np.ascontiguousarray(data)  # keeps the source alive
        self.batch_size = int(batch_size)
        n = self.data.shape[0]
        sample_bytes = int(self.data.nbytes // max(n, 1))
        self._sample_shape = self.data.shape[1:]
        self._dtype = self.data.dtype
        self._h = lib.ffdl_create(
            self.data.ctypes.data_as(ctypes.c_void_p),
            n, sample_bytes, self.batch_size,
            1 if shuffle else 0, seed, int(prefetch_depth),
        )
        if not self._h:
            raise ValueError(
                f"ffdl_create rejected n={n} batch={batch_size} "
                f"depth={prefetch_depth}")
        self.num_batches = n // self.batch_size

    def next_batch(self):
        import numpy as np

        ptr = self._lib.ffdl_next(self._h)
        buf = (ctypes.c_char * (self.batch_size
                                * int(np.prod(self._sample_shape, dtype=int))
                                * self._dtype.itemsize)).from_address(ptr)
        # the returned view must keep the stream (and its ring memory) alive:
        # the array's base chain holds `buf`, and `buf` holds the stream —
        # dropping the BatchStream while retaining the batch is then safe
        # (the valid-until-next-call rule still bounds the CONTENT's life)
        buf._ffstream = self
        return np.frombuffer(buf, dtype=self._dtype).reshape(
            (self.batch_size,) + self._sample_shape)

    @property
    def epoch(self) -> int:
        return int(self._lib.ffdl_epoch(self._h))

    def reset(self) -> None:
        self._lib.ffdl_reset(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ffdl_destroy(self._h)
            self._h = None

    def __del__(self):  # best-effort: stop the producer thread
        try:
            self.close()
        except Exception:
            pass

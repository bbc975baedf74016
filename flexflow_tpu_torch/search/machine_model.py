"""Machine models: analytic cost of compute and communication on a set
of chips (counterpart of flexflow_tpu/search/machine_model.py, copied
host-only: no torch, no jax).

Reference: include/flexflow/simulator.h MachineModel hierarchy —
SimpleMachineModel (flat intra/inter-node bandwidth, simulator.h:229),
EnhancedMachineModel (config-file devices/buses, simulator.h:279-513),
NetworkedMachineModel (topology ConnectionMatrix + routing, simulator.h:515).

The JAX package's units are TPU chips joined by ICI links in a torus,
pods joined by DCN; collectives use the ring/torus formulas. The same
formulas price a GPU host: `CHIP_SPECS["h100-sxm"]` is one H100 SXM from
NVIDIA's data sheet, its NVLink through the NVSwitch given as two
225 GB/s "ICI" links (TpuPodModel's two-link ring: 450 GB/s each way a
card), its "DCN" one 400 Gb/s NDR InfiniBand NIC a card. A tiered spec
of a cluster of 8-card hosts (HierarchicalMachineModel.from_json):

    {"chip": "h100-sxm",
     "tiers": [{"name": "nvlink", "degree": 8, "gbps": 450.0, "links": 1},
               {"name": "ib", "degree": 4, "gbps": 50.0, "links": 1}]}

`make_machine_model` prices with "h100-sxm" for a config whose device is
CUDA and with the JAX default "tpu-v5e" on the CPU (so a CPU model prices
as the JAX package's does); a spec file's "chip" key wins either way.
The TPU entries are the JAX package's figures, kept for its spec files
and tests; none is a target of the port.

Beyond the flat models, `HierarchicalMachineModel` makes the spec a
chip -> host -> pod -> cluster tier hierarchy: collectives decompose
over the tiers a device group actually spans, and reductions can be
priced per strategy ({flat, rs_ar_ag, hier_ring}) so the Unity search
synthesizes per-tier reduction schedules jointly with placement
(arXiv:2110.10548).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ChipSpec:
    """Peak numbers for one chip (the defaults: a TPU v5e, the JAX
    package's default)."""

    name: str = "tpu-v5e"
    peak_bf16_tflops: float = 197.0
    peak_f32_tflops: float = 49.0
    hbm_gb: float = 16.0
    hbm_bw_gbps: float = 819.0  # GB/s
    vmem_mb: float = 128.0
    ici_link_gbps: float = 45.0  # GB/s per direction per link
    ici_links_per_chip: int = 4  # 2D torus: +x,-x,+y,-y
    dcn_gbps: float = 25.0 / 8  # GB/s per host NIC


CHIP_SPECS = {
    "tpu-v5e": ChipSpec(),
    "tpu-v5p": ChipSpec(
        name="tpu-v5p", peak_bf16_tflops=459.0, peak_f32_tflops=115.0,
        hbm_gb=95.0, hbm_bw_gbps=2765.0, ici_link_gbps=90.0,
        ici_links_per_chip=6,
    ),
    "tpu-v4": ChipSpec(
        name="tpu-v4", peak_bf16_tflops=275.0, peak_f32_tflops=69.0,
        hbm_gb=32.0, hbm_bw_gbps=1228.0, ici_link_gbps=50.0,
        ici_links_per_chip=6,
    ),
    # NVIDIA H100 SXM5 80 GB data sheet, dense (no sparsity), 700 W:
    # bf16 tensor cores 989 TFLOP/s; f32 on the CUDA cores 67 TFLOP/s (the
    # port's f32 matmuls and convolutions run in true f32, not TF32);
    # HBM3 80 GB at 3.35 TB/s; L2 50 MB (the `vmem_mb` slot); NVLink 4
    # through the NVSwitch, 900 GB/s a card both ways, so 450 each way,
    # given as 2 links of 225 (TpuPodModel rings over 2 links); one
    # 400 Gb/s NDR NIC a card, 50 GB/s
    "h100-sxm": ChipSpec(
        name="h100-sxm", peak_bf16_tflops=989.0, peak_f32_tflops=67.0,
        hbm_gb=80.0, hbm_bw_gbps=3350.0, vmem_mb=50.0, ici_link_gbps=225.0,
        ici_links_per_chip=2, dcn_gbps=50.0,
    ),
}


class MachineModel:
    """Abstract cost oracle (reference: simulator.h:212).

    The latency constants that used to be `+ 1.0` literals are now named
    COEFFICIENTS (`dispatch_overhead_us`, `collective_latency_us`,
    `step_time_scale`) so a fitted profile (obs/refit.py) can overlay
    measured values over the hand-set defaults — see `apply_overlay`."""

    def __init__(self, num_chips: int, chip: ChipSpec):
        self.num_chips = num_chips
        self.chip = chip
        # fit-able coefficients, defaulting to the historical constants
        self.dispatch_overhead_us = 1.0   # per-op dispatch/launch latency
        self.collective_latency_us = 1.0  # per-collective base latency
        # whole-step multiplier for systematic bias no per-op/per-link term
        # can attribute (fusion wins, host dispatch, bwd-factor error).
        # Uniform across candidate plans, so it never changes a ranking —
        # only Simulator.simulate applies it, never per-op costs.
        self.step_time_scale = 1.0

    def version(self) -> int:
        return 0

    def apply_overlay(self, coeffs) -> None:
        """Overlay fitted coefficients (obs/refit.FittedCoefficients or any
        object with the same fields) over the hand-set machine constants:
        per-dtype effective flop rates, HBM/ICI bandwidth scales, and the
        latency/step terms. The ChipSpec is replaced (dataclasses.replace),
        never mutated — CHIP_SPECS entries are shared."""
        cs = dict(getattr(coeffs, "compute_scale", {}) or {})
        self.chip = dataclasses.replace(
            self.chip,
            peak_bf16_tflops=self.chip.peak_bf16_tflops
            * float(cs.get("bf16", 1.0)),
            peak_f32_tflops=self.chip.peak_f32_tflops
            * float(cs.get("f32", 1.0)),
            hbm_bw_gbps=self.chip.hbm_bw_gbps
            * float(getattr(coeffs, "hbm_scale", 1.0)),
            ici_link_gbps=self.chip.ici_link_gbps
            * float(getattr(coeffs, "link_bw_scale", 1.0)),
        )
        self.dispatch_overhead_us = float(
            getattr(coeffs, "dispatch_latency_us", self.dispatch_overhead_us))
        self.collective_latency_us = float(
            getattr(coeffs, "collective_latency_us",
                    self.collective_latency_us))
        self.step_time_scale = float(
            getattr(coeffs, "step_scale", self.step_time_scale))

    # -- compute ----------------------------------------------------------
    def compute_time_us(self, flops: float, bytes_accessed: float,
                        dtype_bytes: int = 4) -> float:
        """Roofline: max(flops/peak, bytes/hbm_bw), in microseconds."""
        peak = (
            self.chip.peak_bf16_tflops if dtype_bytes <= 2
            else self.chip.peak_f32_tflops
        ) * 1e12
        t_flops = flops / peak
        t_mem = bytes_accessed / (self.chip.hbm_bw_gbps * 1e9)
        return max(t_flops, t_mem) * 1e6 + self.dispatch_overhead_us

    # -- communication ----------------------------------------------------
    def link_bw(self, n_participants: int) -> float:
        raise NotImplementedError

    def allreduce_time_us(self, bytes_: float, n: int) -> float:
        if n <= 1:
            return 0.0
        bw = self.link_bw(n)
        return (2.0 * (n - 1) / n * bytes_ / bw * 1e6
                + self.collective_latency_us)

    def allgather_time_us(self, bytes_per_shard: float, n: int) -> float:
        if n <= 1:
            return 0.0
        bw = self.link_bw(n)
        return ((n - 1) * bytes_per_shard / bw * 1e6
                + self.collective_latency_us)

    def reduce_scatter_time_us(self, bytes_: float, n: int) -> float:
        if n <= 1:
            return 0.0
        bw = self.link_bw(n)
        return ((n - 1) / n * bytes_ / bw * 1e6
                + self.collective_latency_us)

    def all_to_all_time_us(self, bytes_: float, n: int) -> float:
        if n <= 1:
            return 0.0
        # each chip sends (n-1)/n of its bytes; torus bisection limits this
        bw = self.link_bw(n)
        return ((n - 1) / n * bytes_ / bw * 1e6
                + self.collective_latency_us)

    def p2p_time_us(self, bytes_: float) -> float:
        return (bytes_ / (self.chip.ici_link_gbps * 1e9) * 1e6
                + self.collective_latency_us)

    def p2p_single_path_time_us(self, bytes_: float) -> float:
        """p2p over ONE path/direction — for patterns where every chip
        pushes the same way simultaneously (the ring-SP neighbor ppermute),
        so ECMP direction-splitting cannot apply. The base-model p2p is
        already single-link; NetworkedMachineModel overrides both."""
        return self.p2p_time_us(bytes_)

    def comm_channels(self) -> bool:
        """True when the model can price independent mesh axes as disjoint
        link sets (dp grad allreduce rides the 'data' rings while a tp
        activation allreduce rides the 'model' rings concurrently; same-axis
        collectives contend and serialize). This is the TPU-native analog of
        the reference's per-link congestion queues
        (EnhancedMachineModel, simulator.h:279-513): contention is modeled
        at the granularity XLA's collectives actually use — torus axes —
        instead of individual bus segments."""
        return False

    def memory_budget_bytes(self) -> float:
        return self.chip.hbm_gb * 1e9


class SimpleMachineModel(MachineModel):
    """Flat model (reference: SimpleMachineModel simulator.h:229): all chips
    see the same effective per-chip bandwidth."""

    def version(self) -> int:
        return 0

    def link_bw(self, n_participants: int) -> float:
        return self.chip.ici_link_gbps * 1e9


class TpuPodModel(MachineModel):
    """Torus-aware model (plays the role of the reference's
    EnhancedMachineModel, v1): chips arranged in a 2D/3D torus; collectives
    ride ICI rings along mesh axes (bidirectional => 2 links), crossing a pod
    boundary falls back to DCN."""

    def __init__(self, num_chips: int, chip: Optional[ChipSpec] = None,
                 torus_dims: Optional[Tuple[int, ...]] = None,
                 chips_per_pod: int = 256):
        super().__init__(num_chips, chip or CHIP_SPECS["tpu-v5e"])
        if torus_dims is None:
            side = int(math.isqrt(num_chips))
            if side * side == num_chips:
                torus_dims = (side, side)
            else:
                torus_dims = (num_chips,)
        self.torus_dims = torus_dims
        self.chips_per_pod = chips_per_pod

    def version(self) -> int:
        return 1

    def comm_channels(self) -> bool:
        return True  # a torus axis per mesh axis: disjoint link sets

    def link_bw(self, n_participants: int) -> float:
        if n_participants > self.chips_per_pod:
            return self.chip.dcn_gbps * 1e9
        # bidirectional ring along one torus axis: 2 links usable
        return 2.0 * self.chip.ici_link_gbps * 1e9


class NetworkedMachineModel(MachineModel):
    """Explicit-topology model (reference: NetworkedMachineModel
    simulator.h:515 + network.cc routing): a chip-to-chip connection matrix
    with per-link bandwidth. p2p transfers are multi-hop and SEGMENT
    PIPELINED — a message is cut into `segment_mb` chunks so hop h forwards
    chunk i while hop h+1 carries chunk i-1 (the reference's
    segment-pipelining analog, network.cc) — and `routing="ecmp"` spreads a
    transfer over the available equal-cost directions (network.cc:47
    routing strategies). Collectives use the bottleneck link along a ring
    embedding."""

    def __init__(self, num_chips: int, chip: Optional[ChipSpec] = None,
                 connection: Optional[np.ndarray] = None,
                 link_gbps: float = 45.0, segment_mb: float = 1.0,
                 routing: str = "ecmp"):
        super().__init__(num_chips, chip or CHIP_SPECS["tpu-v5e"])
        if connection is None:
            # default: 1-D bidirectional ring
            connection = np.zeros((num_chips, num_chips))
            for i in range(num_chips):
                connection[i][(i + 1) % num_chips] = 1
                connection[(i + 1) % num_chips][i] = 1
        self.connection = connection
        self.link_gbps = link_gbps
        self.segment_bytes = segment_mb * 1e6
        if routing not in ("ecmp", "single"):
            raise ValueError(
                f"routing={routing!r}: use 'ecmp' (split over equal-cost "
                "directions) or 'single' (one path)")
        self.routing = routing
        self._avg_hops: Optional[float] = None
        self._hops_cache: Dict[int, List[int]] = {}
        self._min_degree_cache: Optional[int] = None

    def version(self) -> int:
        return 2

    def _min_degree(self) -> int:
        # cached: p2p_time_us sits in the simulator's per-candidate hot
        # path via path_diversity (the topology is immutable after init)
        if self._min_degree_cache is None:
            self._min_degree_cache = max(
                1, int(self.connection.sum(axis=1).min()))
        return self._min_degree_cache

    def comm_channels(self) -> bool:
        """Per-axis overlap needs disjoint link sets per mesh axis: a chip
        with 4+ links (a 2D torus's +-x/+-y) can dedicate a ring pair per
        axis; a 1-D ring (degree 2) has ONE link set every collective
        shares, so the single serializing timeline is the honest model."""
        return self._min_degree() >= 4

    @classmethod
    def from_json(cls, spec_or_path, chip: Optional[ChipSpec] = None):
        """Load topology from a JSON file — or an already-parsed spec dict
        (the elastic coordinator builds shrunken survivor specs in memory):
        {"num_chips": N, "links": [[i, j, gbps], ...], "segment_mb": 1.0,
        "routing": "ecmp"} (role of --machine-model-file + the reference's
        routing/segment knobs). A spec with no/empty "links" keeps the
        default 45 GB/s and falls back to the default 1-D ring topology;
        "num_chips" defaults to 1 + the highest chip id named in "links"."""
        if isinstance(spec_or_path, str):
            with open(spec_or_path) as f:
                spec = json.load(f)
        else:
            spec = dict(spec_or_path)
        links = spec.get("links") or []
        n = spec.get("num_chips")
        if n is None:
            n = max((max(i, j) for i, j, _ in links), default=0) + 1
        gbps = 45.0
        conn = None  # no links: the default ring of the constructor
        if links:
            conn = np.zeros((n, n))
            for i, j, g in links:
                conn[i][j] = conn[j][i] = 1
                gbps = g
        return cls(n, chip, conn, gbps,
                   segment_mb=float(spec.get("segment_mb", 1.0)),
                   routing=spec.get("routing", "ecmp"))

    def _adjacency(self) -> List[List[int]]:
        adj = getattr(self, "_adj", None)
        if adj is None:
            adj = self._adj = [
                [v for v in range(self.num_chips) if self.connection[u][v]]
                for u in range(self.num_chips)
            ]
        return adj

    def _sssp_hops(self, src: int) -> List[int]:
        """Single-source BFS distance map (disconnected: num_chips)."""
        from collections import deque

        adj = self._adjacency()
        dist = [self.num_chips] * self.num_chips
        dist[src] = 0
        q = deque([src])
        while q:
            u = q.popleft()
            for v in adj[u]:
                if dist[v] > dist[u] + 1:
                    dist[v] = dist[u] + 1
                    q.append(v)
        return dist

    def _hops(self, src: int) -> List[int]:
        """Cached single-source distance map (topology is immutable)."""
        if src not in self._hops_cache:
            self._hops_cache[src] = self._sssp_hops(src)
        return self._hops_cache[src]

    def hop_count(self, src: int, dst: int) -> int:
        return self._hops(src)[dst]

    def avg_hops(self) -> float:
        """Mean shortest-path length over distinct pairs (cached; one BFS
        per source — the simulator hot path touches this through
        p2p_time_us). The cost model has no device placement under GSPMD —
        one program spans the mesh — so multi-hop depth is priced at the
        topology's average."""
        if self._avg_hops is None:
            n = self.num_chips
            if n <= 1:
                self._avg_hops = 1.0
            else:
                total = sum(sum(self._hops(i)) for i in range(n))
                self._avg_hops = max(1.0, total / (n * (n - 1)))
        return self._avg_hops

    def path_diversity(self) -> float:
        """Equal-cost directions a transfer can split over: bounded by the
        sparsest chip's link degree, capped at 4 (the +-x/+-y of a 2D
        torus); 1 under single-path routing."""
        if self.routing != "ecmp":
            return 1.0
        return float(min(self._min_degree(), 4))

    def apply_overlay(self, coeffs) -> None:
        # the explicit-topology model prices links off its OWN link_gbps,
        # not the chip spec's — scale both so link_bw/p2p agree
        super().apply_overlay(coeffs)
        self.link_gbps *= float(getattr(coeffs, "link_bw_scale", 1.0))

    def _p2p_time(self, bytes_: float, diversity: float) -> float:
        bw = self.link_gbps * 1e9 * diversity
        seg = min(self.segment_bytes, max(bytes_, 1.0))
        h = self.avg_hops()
        # pipelined store-and-forward: the head segment pays every hop,
        # the rest stream behind it at line rate
        return ((bytes_ + (h - 1.0) * seg) / bw * 1e6
                + self.collective_latency_us)

    def p2p_time_us(self, bytes_: float) -> float:
        return self._p2p_time(bytes_, self.path_diversity())

    def p2p_single_path_time_us(self, bytes_: float) -> float:
        """One-directional transfer: every chip sends the same way at once
        (ring-SP neighbor ppermute), so the transfer cannot split over the
        equal-cost directions ECMP would otherwise use."""
        return self._p2p_time(bytes_, 1.0)

    def link_bw(self, n_participants: int) -> float:
        return min(self._min_degree(), 2) * self.link_gbps * 1e9


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One level of a hierarchical interconnect, innermost first.

    `degree` is the fan-out at this tier (chips per host-ICI group, pods
    per DCN domain, ...); `bw_gbps` the per-direction per-link bandwidth;
    `links` the parallel usable links of one group's ring (bidirectional
    ICI ring = 2, a single host NIC = 1); `latency_us` the per-collective
    base latency at this tier (None = the model's fit-able
    `collective_latency_us`, which keeps one-tier hierarchies bit-for-bit
    identical to the flat models and lets a fitted profile overlay it)."""

    name: str
    degree: int
    bw_gbps: float
    links: int = 2
    latency_us: Optional[float] = None


# per-tier reduction strategies the Unity search synthesizes for synced
# tensors (arXiv:2110.10548: placement + reduction strategy are chosen
# jointly on hierarchical systems):
#  - flat:      one ring over every participant, bottlenecked by the
#               slowest tier crossed — the only choice inside ONE tier,
#               and what a flat machine model implicitly prices;
#  - rs_ar_ag:  reduce-scatter within each inner tier, all-reduce at the
#               outermost tier on the 1/prod(inner) shard, all-gather back
#               out — minimal slow-tier traffic, one phase per tier;
#  - hier_ring: a full-bytes ring per tier — more outer-tier traffic than
#               rs_ar_ag but fewer phases, wins for small tensors where
#               per-phase latency dominates.
# A degree spanning a tier boundary must use a tier-decomposable strategy
# (rs_ar_ag or hier_ring) — the FFTA070 legality rule; "auto" therefore
# never picks flat across a boundary.
REDUCTION_FLAT = "flat"
REDUCTION_RS_AR_AG = "rs_ar_ag"
REDUCTION_HIER_RING = "hier_ring"
REDUCTION_STRATEGIES = (REDUCTION_FLAT, REDUCTION_RS_AR_AG,
                        REDUCTION_HIER_RING)


class HierarchicalMachineModel(MachineModel):
    """Tiered machine spec: chip -> host/ICI -> pod -> DCN, each tier with
    its own bandwidth, latency, and degree (ROADMAP item 1, following
    arXiv:2110.10548). Collectives decompose over the tier path a device
    group actually spans — `tier_path(n, inner)` — so a cross-pod
    all-reduce no longer prices like a neighbor hop, and the simulator
    can ask for a specific per-tier reduction strategy
    (`allreduce_time_us(..., strategy=...)`).

    A ONE-tier hierarchy prices identically to the flat `TpuPodModel`
    (pinned by tests/test_machine_hierarchy.py): the single-tier formulas
    below mirror the base-class expressions term for term."""

    def __init__(self, tiers: Sequence[TierSpec],
                 chip: Optional[ChipSpec] = None):
        tiers = list(tiers)
        if not tiers:
            raise ValueError("HierarchicalMachineModel needs >= 1 tier")
        n = 1
        for t in tiers:
            if t.degree < 1 or t.bw_gbps <= 0 or t.links < 1:
                raise ValueError(f"bad tier spec {t!r}")
            n *= t.degree
        super().__init__(n, chip or CHIP_SPECS["tpu-v5e"])
        self.tiers = tiers
        # per-tier bandwidth overlay multipliers (obs/refit.py fits these
        # keyed by tier name; apply_overlay folds them in)
        self.tier_scales: Dict[str, float] = {t.name: 1.0 for t in tiers}

    def version(self) -> int:
        return 3

    def comm_channels(self) -> bool:
        return True  # disjoint ring sets per mesh axis, like TpuPodModel

    # -- tier geometry ----------------------------------------------------
    def tier_bw(self, tier: TierSpec) -> float:
        """Usable bytes/s of one tier's ring (links x per-link bw x fitted
        per-tier scale)."""
        return tier.links * (
            tier.bw_gbps * self.tier_scales.get(tier.name, 1.0)) * 1e9

    def tier_latency(self, tier: TierSpec) -> float:
        return (self.collective_latency_us if tier.latency_us is None
                else float(tier.latency_us))

    def tier_path(self, n: int, inner: int = 1) -> List[Tuple[TierSpec, int]]:
        """[(tier, participants), ...] inner->outer spanned by a group of
        `n` devices whose mesh axis nests OUTSIDE `inner` inner devices
        (mesh axes are row-major: an axis of size n with inner stride
        `inner` occupies device ids [i*inner, (i+1)*inner) x n). Tiers
        the group never crosses are omitted; participant counts round up
        (a non-dividing group conservatively spans the next tier)."""
        path: List[Tuple[TierSpec, int]] = []
        cprev = 1
        span = max(1, inner) * max(1, n)
        for t in self.tiers:
            c = cprev * t.degree
            ni = -(-min(c, span) // max(cprev, inner))  # ceil division
            if ni > 1:
                path.append((t, ni))
            cprev = c
        return path

    def crosses_tier_boundary(self, n: int, inner: int = 1) -> bool:
        """True when the group's traffic leaves the innermost tier —
        either the path spans several tiers, or the group's members are
        spread so wide (large inner stride) that even a single-tier path
        rides an outer tier's links."""
        path = self.tier_path(n, inner)
        return bool(path) and (len(path) > 1
                               or path[0][0] is not self.tiers[0])

    def link_bw(self, n_participants: int) -> float:
        """Bottleneck bandwidth over the tiers an n-group spans (generic
        base-class consumers; the collective methods below decompose)."""
        path = self.tier_path(n_participants)
        if not path:
            return self.tier_bw(self.tiers[0])
        return min(self.tier_bw(t) for t, _ in path)

    # -- strategy-priced collectives --------------------------------------
    def _flat_allreduce(self, bytes_: float, n: int, path) -> float:
        # one ring over all n participants: the slowest tier's links carry
        # every step, and the outermost tier's latency applies (base-class
        # expression order kept so a one-tier path is bit-for-bit
        # MachineModel.allreduce_time_us)
        bw = min(self.tier_bw(t) for t, _ in path)
        lat = self.tier_latency(path[-1][0])
        return 2.0 * (n - 1) / n * bytes_ / bw * 1e6 + lat

    def _rs_ar_ag(self, bytes_: float, path) -> float:
        # reduce-scatter up the inner tiers, all-reduce the residual shard
        # at the outermost tier, all-gather back down
        t = 0.0
        shard = bytes_
        for tier, ni in path[:-1]:
            t += ((ni - 1) / ni * shard / self.tier_bw(tier) * 1e6
                  + self.tier_latency(tier))
            shard /= ni
        tier, ni = path[-1]
        t += (2.0 * (ni - 1) / ni * shard / self.tier_bw(tier) * 1e6
              + self.tier_latency(tier))
        for tier, ni in reversed(path[:-1]):
            t += ((ni - 1) * shard / self.tier_bw(tier) * 1e6
                  + self.tier_latency(tier))
            shard *= ni
        return t

    def _hier_ring(self, bytes_: float, path) -> float:
        # a full-bytes ring per tier (fewer phases than rs_ar_ag; the
        # outer tiers carry the whole tensor)
        return sum(
            2.0 * (ni - 1) / ni * bytes_ / self.tier_bw(tier) * 1e6
            + self.tier_latency(tier)
            for tier, ni in path)

    def allreduce_time_us(self, bytes_: float, n: int, inner: int = 1,
                          strategy: str = "auto") -> float:
        if n <= 1:
            return 0.0
        path = self.tier_path(n, inner)
        if not path:
            return 0.0
        if len(path) == 1:
            return self._flat_allreduce(bytes_, n, path)
        if strategy == "auto":
            # flat excluded across a boundary: FFTA070 legality — every
            # synthesized cross-tier reduction is tier-decomposable
            return min(self._rs_ar_ag(bytes_, path),
                       self._hier_ring(bytes_, path))
        if strategy == REDUCTION_FLAT:
            return self._flat_allreduce(bytes_, n, path)
        if strategy == REDUCTION_RS_AR_AG:
            return self._rs_ar_ag(bytes_, path)
        if strategy == REDUCTION_HIER_RING:
            return self._hier_ring(bytes_, path)
        raise ValueError(
            f"unknown reduction strategy {strategy!r}; choices:"
            f" {REDUCTION_STRATEGIES} or 'auto'")

    def reduction_choice(self, bytes_: float, n: int, inner: int = 1
                         ) -> Tuple[str, float, List[Dict[str, Any]]]:
        """(strategy, time_us, tier decomposition) for one synced tensor —
        what the Unity search records on the plan (SearchResult
        .reduction_strategies) and the FFTA07x gate checks. Within one
        tier the only (and legal) choice is flat; across a boundary the
        cheapest tier-decomposable strategy wins."""
        path = self.tier_path(n, inner)
        tiers = [{"tier": t.name, "group": ni} for t, ni in path]
        if n <= 1 or not path:
            return REDUCTION_FLAT, 0.0, tiers
        if len(path) == 1:
            return (REDUCTION_FLAT,
                    self._flat_allreduce(bytes_, n, path), tiers)
        best = min(
            ((s, self.allreduce_time_us(bytes_, n, inner=inner, strategy=s))
             for s in (REDUCTION_RS_AR_AG, REDUCTION_HIER_RING)),
            key=lambda kv: kv[1])
        return best[0], best[1], tiers

    def allgather_time_us(self, bytes_per_shard: float, n: int,
                          inner: int = 1) -> float:
        if n <= 1:
            return 0.0
        path = self.tier_path(n, inner)
        if not path:
            return 0.0
        if len(path) == 1:
            tier, _ = path[0]
            bw = self.tier_bw(tier)
            return ((n - 1) * bytes_per_shard / bw * 1e6
                    + self.tier_latency(tier))
        # tiered: gather outer-first so the slow tiers move the small
        # per-shard chunks and the fast inner tiers the grown ones
        t = 0.0
        gathered = bytes_per_shard
        for tier, ni in reversed(path):
            t += ((ni - 1) * gathered / self.tier_bw(tier) * 1e6
                  + self.tier_latency(tier))
            gathered *= ni
        flat = ((n - 1) * bytes_per_shard
                / min(self.tier_bw(tr) for tr, _ in path) * 1e6
                + self.tier_latency(path[-1][0]))
        return min(t, flat)

    def reduce_scatter_time_us(self, bytes_: float, n: int,
                               inner: int = 1) -> float:
        if n <= 1:
            return 0.0
        path = self.tier_path(n, inner)
        if not path:
            return 0.0
        if len(path) == 1:
            tier, _ = path[0]
            bw = self.tier_bw(tier)
            return ((n - 1) / n * bytes_ / bw * 1e6
                    + self.tier_latency(tier))
        # mirror of the tiered allgather: scatter inner-first so the slow
        # tiers only carry the already-reduced shard
        t = 0.0
        b = bytes_
        for tier, ni in path:
            t += ((ni - 1) / ni * b / self.tier_bw(tier) * 1e6
                  + self.tier_latency(tier))
            b /= ni
        flat = ((n - 1) / n * bytes_
                / min(self.tier_bw(tr) for tr, _ in path) * 1e6
                + self.tier_latency(path[-1][0]))
        return min(t, flat)

    def all_to_all_time_us(self, bytes_: float, n: int,
                           inner: int = 1) -> float:
        if n <= 1:
            return 0.0
        path = self.tier_path(n, inner)
        if not path:
            return 0.0
        if len(path) == 1:
            tier, _ = path[0]
            bw = self.tier_bw(tier)
            return ((n - 1) / n * bytes_ / bw * 1e6
                    + self.tier_latency(tier))
        # each chip's traffic splits by destination distance: the share
        # leaving its tier-i group must cross tier i's links
        n_eff = 1
        for _, ni in path:
            n_eff *= ni
        t = 0.0
        cprev = 1
        for tier, ni in path:
            frac = (n_eff - cprev) / n_eff
            t += bytes_ * frac / self.tier_bw(tier) * 1e6
            cprev *= ni
        return t + self.tier_latency(path[-1][0])

    def dcn_step_bytes(self, bytes_: float, n: int, inner: int = 1,
                       strategy: str = "auto") -> float:
        """Bytes one chip's collective actually pushes across the
        OUTERMOST tier it spans, under `strategy` — the FFTA071 warning's
        measure of per-step DCN pressure. 0 when the group never leaves
        the innermost tier; a group living entirely ON an outer tier
        (e.g. dp=2 with one member per pod) rings its full bytes there."""
        path = self.tier_path(n, inner)
        if not path or (len(path) == 1 and path[0][0] is self.tiers[0]):
            return 0.0
        tier, ni = path[-1]
        if strategy == "auto":
            strategy, _, _ = self.reduction_choice(bytes_, n, inner=inner)
        if strategy == REDUCTION_RS_AR_AG:
            shard = bytes_
            for _, nj in path[:-1]:
                shard /= nj
            return 2.0 * (ni - 1) / ni * shard
        # flat and hier_ring both ring the full tensor across the top tier
        return 2.0 * (ni - 1) / ni * bytes_

    def p2p_time_us(self, bytes_: float) -> float:
        # neighbor transfers ride the innermost tier's links (single
        # direction, like the flat models' per-link p2p); tier_latency
        # honors an explicit innermost latency_us, same as ring_hop and
        # every collective (None keeps the fit-able collective latency,
        # which is the flat models' expression bit-for-bit)
        tier = self.tiers[0]
        bw = (tier.bw_gbps * self.tier_scales.get(tier.name, 1.0)) * 1e9
        return bytes_ / bw * 1e6 + self.tier_latency(tier)

    def ring_hop_time_us(self, bytes_: float, n: int,
                         inner: int = 1) -> float:
        """One simultaneous neighbor hop of a ring laid over an n-wide
        mesh axis with stride `inner` (the ring-SP K/V rotation, spatial
        halo exchanges): every chip pushes the same direction at once, so
        the rotation advances at the SLOWEST link the ring crosses — a
        ring spanning two pods pays the DCN hop on every rotation step,
        not the ICI neighbor price."""
        path = self.tier_path(n, inner)
        if not path:
            return self.p2p_time_us(bytes_)
        tier = path[-1][0]  # outermost tier crossed: the bottleneck hop
        bw = (tier.bw_gbps * self.tier_scales.get(tier.name, 1.0)) * 1e9
        return bytes_ / bw * 1e6 + self.tier_latency(tier)

    def apply_overlay(self, coeffs) -> None:
        """Overlay fitted coefficients. Per-tier link scales
        (`coeffs.tier_link_scales`, keyed by tier name — obs/refit.py)
        win for the tiers they name; unnamed tiers fall back to the
        single `link_bw_scale`, so profiles fitted against flat specs
        still apply."""
        super().apply_overlay(coeffs)
        per_tier = dict(getattr(coeffs, "tier_link_scales", {}) or {})
        global_scale = float(getattr(coeffs, "link_bw_scale", 1.0))
        for t in self.tiers:
            self.tier_scales[t.name] = (
                self.tier_scales.get(t.name, 1.0)
                * float(per_tier.get(t.name, global_scale)))

    @classmethod
    def from_json(cls, spec_or_path, chip: Optional[ChipSpec] = None
                  ) -> "HierarchicalMachineModel":
        """Load a tiered spec — a JSON file path or an already-parsed
        dict: {"chip": "tpu-v5e", "tiers": [{"name": "ici", "degree": 8,
        "gbps": 45.0, "links": 2}, {"name": "dcn", "degree": 2,
        "gbps": 3.125, "links": 1, "latency_us": 10.0}]} with tiers
        listed innermost first (docs/machine.md). num_chips is the
        product of tier degrees."""
        if isinstance(spec_or_path, str):
            with open(spec_or_path) as f:
                spec = json.load(f)
        else:
            spec = dict(spec_or_path)
        raw = spec.get("tiers")
        if not raw:
            raise ValueError("hierarchical machine spec needs a non-empty"
                             " 'tiers' list")
        tiers = []
        for i, t in enumerate(raw):
            try:
                tiers.append(TierSpec(
                    name=str(t.get("name", f"tier{i}")),
                    degree=int(t["degree"]),
                    bw_gbps=float(t["gbps"]),
                    links=int(t.get("links", 2)),
                    latency_us=(None if t.get("latency_us") is None
                                else float(t["latency_us"]))))
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f"bad tier entry #{i} ({t!r}) in machine spec: {e}"
                ) from e
        if len({t.name for t in tiers}) != len(tiers):
            raise ValueError("tier names must be unique: "
                             + str([t.name for t in tiers]))
        if chip is None:
            chip = CHIP_SPECS.get(spec.get("chip", "tpu-v5e"))
            if chip is None:
                raise ValueError(f"unknown chip {spec.get('chip')!r} in"
                                 f" machine spec; choices: "
                                 + str(sorted(CHIP_SPECS)))
        declared = spec.get("num_chips")
        model = cls(tiers, chip)
        if declared is not None and int(declared) != model.num_chips:
            raise ValueError(
                f"machine spec declares num_chips={declared} but the tier"
                f" degrees multiply to {model.num_chips}")
        return model


def load_machine_spec(path_or_spec):
    """Parse a --machine-spec/--machine-model-file value into a dict (the
    from_json constructors also accept dicts, so the file is read once)."""
    if isinstance(path_or_spec, str):
        with open(path_or_spec) as f:
            return json.load(f)
    return dict(path_or_spec)


def spec_num_chips(spec: Dict) -> int:
    """Chip count of a parsed machine-spec dict, by each format's own
    rule: the product of tier degrees for hierarchical specs (what
    HierarchicalMachineModel.__init__ computes and validates), else the
    declared num_chips, else NetworkedMachineModel.from_json's
    highest-chip-id-in-links inference. ONE place for the rule — the
    elastic coordinator's spec normalization and shrink logic share it
    with the model constructors."""
    if spec.get("tiers"):
        n = 1
        for t in spec["tiers"]:
            n *= int(t["degree"])
        return n
    if "num_chips" in spec:
        return int(spec["num_chips"])
    links = spec.get("links") or []
    return max((max(i, j) for i, j, _ in links), default=0) + 1


def default_chip(config) -> str:
    """The chip a config prices with: "h100-sxm" when its device is CUDA,
    the JAX package's default "tpu-v5e" otherwise (the CPU)."""
    device = str(getattr(config, "device", "cpu") or "cpu")
    return "h100-sxm" if device.startswith("cuda") else "tpu-v5e"


def config_backend(config) -> str:
    """The backend name a config runs on, as `jax.default_backend()`
    names the same hardware: "gpu" for a CUDA device, else "cpu" — what a
    fitted profile's spec hash is keyed by (obs/refit.py)."""
    device = str(getattr(config, "device", "cpu") or "cpu")
    return "gpu" if device.startswith("cuda") else "cpu"


def make_machine_model(config, num_chips: int) -> MachineModel:
    """Factory keyed off FFConfig (reference: --machine-model-version/-file).

    The chip is `default_chip(config)`: the H100 spec on a CUDA config,
    the JAX default on the CPU; a hierarchical spec file's "chip" key
    wins. When `config.fitted_profile_file` names a fitted profile
    (obs/refit.py — measured coefficients from accumulated calibration
    data), it is loaded as an overlay over the hand-set constants, so
    EVERY consumer of this factory (simulator, calibration, MFU
    accounting, KV-pool sizing) prices with measured reality. A profile
    fitted for a different chip or backend refuses to load (typed
    FittedProfileMismatch) rather than silently mis-pricing."""
    chip = CHIP_SPECS[default_chip(config)]
    if getattr(config, "machine_model_file", None):
        # one read, then dispatch: a spec with a "tiers" list is the
        # hierarchical machine; anything else keeps the explicit-topology
        # NetworkedMachineModel format
        spec = load_machine_spec(config.machine_model_file)
        if spec.get("tiers"):
            m = HierarchicalMachineModel.from_json(
                spec, chip if "chip" not in spec else None)
        else:
            m = NetworkedMachineModel.from_json(spec, chip)
    elif getattr(config, "machine_model_version", 0) >= 1:
        m = TpuPodModel(num_chips, chip)
    else:
        m = SimpleMachineModel(num_chips, chip)
    profile_path = getattr(config, "fitted_profile_file", None)
    if profile_path:
        from ..obs.refit import FittedProfile  # lazy: no import cycle

        FittedProfile.load(profile_path, expect_chip=m.chip.name,
                           expect_backend=config_backend(config)
                           ).apply_to(m)
    return m

"""Serverless cluster layer (paper §4.1–§4.4 at fleet scale).

Composes the single-server pieces — PipeBoostEngine cold start/recovery
(core/engine.py) and continuous-batched serving (serving/engine.py) — into
the paper's end-to-end serverless scenario: bursty arrival traces routed
across N server replicas, an autoscaler that cold-starts servers mid-burst
and admits traffic the moment a viable pipeline chain exists, cross-server
re-routing of in-flight requests on a crash, and a JSON metrics layer
(TTFT/TBT percentiles, SLO attainment, queue depth, GPU-seconds).

Replay is discrete-event (cluster/router.py): dense, bit-exact ticks while
any server has work, clock jumps across quiescent gaps to the next
arrival / idle-retire deadline / rejoin — full-day Azure traces stream in
(cluster/traces.py) and replay against modeled servers
(cluster/simserver.py) in seconds.

Scale-out is peer-to-peer when ``ClusterConfig.multicast`` is set
(cluster/multicast.py): spawning servers pull model segments from warm
peers over ICI — chain or tree propagation with mid-transfer failover
(re-root on source crash, resume from the last received segment, host
fallback) — so N simultaneous cold starts cost ~one host read.

Scale-down keeps its warmth when a ``StateTier`` is wired in
(cluster/state_tier.py): idle retirement spills the server's prefix-cache
contents (serving/prefix_cache.py) and resident-adapter set host-side,
and a later spawn for the same pool resurrects them — priced with the
same shared-host-bandwidth model as snapshot transfers.

Scheduling is pluggable (cluster/scheduler.py): batched dispatch policies
(least-loaded / SLO-aware / adapter-affine, all implementing
``select_many``), placement policies for what a spawned server preloads,
and injected clocks (logical ticks vs wall time).  Multi-model fleets
ride cluster/fleet.py: named per-model pools over shared base params with
per-pool autoscalers and cross-pool metrics.

See ``docs/ARCHITECTURE.md`` § "Cluster" for the subsystem map.

The port of ``repro/cluster``: the same names, over the port's engines
(``ClusterServer`` runs on the card, or on the CPU when its params lie
there); the modeled pieces are own copies of the reference's.
"""
from repro_torch.cluster.autoscaler import (Autoscaler, AutoscalerConfig,
                                            ScaleDecision)
from repro_torch.cluster.fleet import Fleet, PoolSpec
from repro_torch.cluster.metrics import ClusterMetrics, percentile
from repro_torch.cluster.multicast import MulticastConfig, MulticastManager
from repro_torch.cluster.router import (ClusterConfig, ClusterRouter,
                                        ClusterServer)
from repro_torch.cluster.scheduler import (DISPATCH_POLICIES, AdapterAffine,
                                           Clock, DispatchPolicy,
                                           HotAdapterPlacement, LeastLoaded,
                                           LogicalClock, PlacementPolicy,
                                           PreloadAll, SloAware, WallClock,
                                           make_dispatch)
from repro_torch.cluster.simserver import (SimProfile, SimServer,
                                           sim_server_factory)
from repro_torch.cluster.state_tier import StateTier
from repro_torch.cluster.traces import (Arrival, ChaosEvent, ChaosSchedule,
                                        arrival_stream, burst_wave_trace,
                                        gamma_trace, iter_azure_trace,
                                        load_azure_trace, load_chaos,
                                        load_trace, merge_traces,
                                        poisson_trace, random_chaos,
                                        repeated_prefix_trace, save_chaos,
                                        save_trace)

__all__ = [
    "AdapterAffine", "Arrival", "Autoscaler", "AutoscalerConfig",
    "ChaosEvent", "ChaosSchedule", "Clock",
    "ClusterConfig", "ClusterMetrics", "ClusterRouter", "ClusterServer",
    "DISPATCH_POLICIES", "DispatchPolicy", "Fleet", "HotAdapterPlacement",
    "LeastLoaded", "LogicalClock", "MulticastConfig", "MulticastManager",
    "PlacementPolicy", "PoolSpec",
    "PreloadAll", "ScaleDecision", "SimProfile", "SimServer", "SloAware",
    "StateTier", "WallClock", "arrival_stream", "burst_wave_trace",
    "gamma_trace", "iter_azure_trace", "load_azure_trace", "load_chaos",
    "load_trace", "make_dispatch", "merge_traces", "percentile",
    "poisson_trace", "random_chaos", "repeated_prefix_trace", "save_chaos",
    "save_trace", "sim_server_factory",
]

"""Cluster layer of the port, copied from ``repro/cluster/`` with its
imports pointed at ``repro_torch``: the hybrid request-recovery policy
(``recovery``), the discrete-event cluster simulator (``simulator``) with
its typed event core (``events``), contended network links (``network``),
spot availability traces (``spot_trace``), request workloads
(``workload``) and the cost-vs-SLO frontier sweep (``frontier``). It
imports numpy and ``repro_torch.core`` only; no torch compute runs here."""

from repro_torch.cluster.events import (Arrive, Event, EventQueue, Interrupt,
                                        Revive, TransferDone, Wake)
from repro_torch.cluster.frontier import (FrontierPoint, pareto_front,
                                          sweep_frontier)
from repro_torch.cluster.network import (LinkSpec, NetworkLink, Topology,
                                         Transfer)
from repro_torch.cluster.recovery import (RecoveryDecision, decide,
                                          kv_bytes_for_ctx,
                                          kv_restore_seconds,
                                          preemption_seconds,
                                          recompute_seconds,
                                          transfer_seconds)
from repro_torch.cluster.simulator import ClusterSim, FTConfig, SimResult
from repro_torch.cluster.spot_trace import (PAPER_POOLS, AvailabilityTrace,
                                            RegionSpec,
                                            correlated_interruption_count,
                                            generate_multi_region_trace,
                                            generate_trace,
                                            interruption_events_for_window,
                                            scaled_pools, select_scenario)
from repro_torch.cluster.workload import (Request, azure_conversation_like,
                                          diurnal_rate, length_histogram)

__all__ = ["ClusterSim", "FTConfig", "SimResult", "PAPER_POOLS",
           "AvailabilityTrace", "generate_trace", "select_scenario",
           "interruption_events_for_window", "Request",
           "azure_conversation_like", "length_histogram",
           # discrete-event core
           "Event", "EventQueue", "Arrive", "Interrupt", "Revive", "Wake",
           "TransferDone",
           # network
           "NetworkLink", "LinkSpec", "Topology", "Transfer",
           # multi-region spot markets
           "RegionSpec", "scaled_pools", "generate_multi_region_trace",
           "correlated_interruption_count",
           # frontier sweep
           "FrontierPoint", "sweep_frontier", "pareto_front",
           "diurnal_rate",
           # hybrid request recovery
           "RecoveryDecision", "decide", "kv_bytes_for_ctx",
           "kv_restore_seconds", "preemption_seconds", "recompute_seconds",
           "transfer_seconds"]

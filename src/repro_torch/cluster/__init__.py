"""Cluster layer of the port: the hybrid request-recovery policy (copy of
``repro/cluster/recovery.py``). The discrete-event cluster simulator and
its spot traces, network and workload models are not ported yet."""

from repro_torch.cluster.recovery import (RecoveryDecision, decide,
                                          kv_bytes_for_ctx,
                                          kv_restore_seconds,
                                          preemption_seconds,
                                          recompute_seconds,
                                          transfer_seconds)

__all__ = ["RecoveryDecision", "decide", "kv_bytes_for_ctx",
           "kv_restore_seconds", "preemption_seconds", "recompute_seconds",
           "transfer_seconds"]

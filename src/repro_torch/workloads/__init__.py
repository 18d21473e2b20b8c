from repro_torch.workloads.faults import FAULT_KINDS, FaultEvent, FaultPlan
from repro_torch.workloads.metrics import LatencyRecorder, latency_summary_us, percentile
from repro_torch.workloads.ycsb import (WORKLOADS, Workload, ZipfianGenerator,
                                  make_ops, run_chaos_workload,
                                  run_failover_workload, run_store_workload)

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultPlan", "WORKLOADS", "Workload",
           "ZipfianGenerator", "make_ops", "LatencyRecorder",
           "latency_summary_us", "percentile", "run_chaos_workload",
           "run_failover_workload", "run_store_workload"]

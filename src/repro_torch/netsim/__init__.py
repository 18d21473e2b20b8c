from repro_torch.netsim.sim import FifoLock, Resource, Simulator, run_process
from repro_torch.netsim.pricing import (ClientCompute, DoorbellTrace, ServerAsync,
                                  SimParams, WrCost, chain_nic_occupancy_s,
                                  chain_steps)
from repro_torch.netsim.verbs import Verbs

__all__ = ["Simulator", "Resource", "FifoLock", "run_process", "SimParams",
           "Verbs", "WrCost", "DoorbellTrace", "ClientCompute", "ServerAsync",
           "chain_steps", "chain_nic_occupancy_s"]

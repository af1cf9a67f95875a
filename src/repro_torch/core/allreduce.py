"""Topology-explicit allreduce schedules (survey §3.3.1(2)): the exact
schedules of ``comm.transport`` under the names the Strategy API parses
(a topology name in a spec's arch slot means allreduce over it)."""
from repro_torch.comm.transport import SCHEDULES

TOPOLOGIES = SCHEDULES

__all__ = ["TOPOLOGIES"]

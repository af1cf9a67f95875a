"""Resource scheduling & elasticity (survey §3.4): a discrete-event
multi-tenant GPU-cluster simulator with pluggable policies (the JAX
package's ``sched/``; numpy and plain Python)."""
from repro_torch.sched.jobs import Job, make_trace
from repro_torch.sched.cluster import Cluster
from repro_torch.sched.policies import POLICIES
from repro_torch.sched.simulator import SimResult, TraceEvent, simulate

__all__ = ["Job", "make_trace", "Cluster", "POLICIES", "simulate",
           "SimResult", "TraceEvent"]

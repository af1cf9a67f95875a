"""Elastic, fault-tolerant training (survey §3.2.3 / §3.4.2; the JAX
package's ``elastic/``).

Makes every registered Strategy cell survivable and resizable:

  events.py    declarative FailurePlan / ResizePlan / StragglerPlan event
               schedules + the sched/-trace adapter (scheduler↔trainer)
  recovery.py  fit_elastic: periodic engine snapshots through
               checkpoint.store, crash rollback + reshard, live resize
  backup.py    bounded drop-slowest-k gradient aggregation (the survey's
               backup-worker straggler mitigation; ``bsp+backup:k``)
  detector.py  measured straggler detection: per-worker step-time EMAs
               feeding the backup drop set (``bsp+backup:k+detect``)

The JAX package's docs/elasticity.md gives the grammar, recovery
semantics and the backup-worker accounting; the port keeps them.
"""
from repro_torch.elastic.backup import drop_set, participation_weights
from repro_torch.elastic.detector import StepTimeEMA
from repro_torch.elastic.events import (ElasticEvent, EventPlan,
                                        FailurePlan, ResizePlan,
                                        StragglerPlan, merge_plans,
                                        plan_from_sched_trace)
from repro_torch.elastic.recovery import (ElasticBatches, fit_elastic,
                                          latest_checkpoint,
                                          restore_engine_state,
                                          save_engine_state)

__all__ = [
    "ElasticEvent", "EventPlan", "FailurePlan", "ResizePlan",
    "StragglerPlan", "merge_plans", "plan_from_sched_trace",
    "fit_elastic", "ElasticBatches", "save_engine_state",
    "restore_engine_state", "latest_checkpoint",
    "drop_set", "participation_weights", "StepTimeEMA",
]

"""Communication plane of the port: exact topology schedules over the
worker axis and the bucketed ``CommPlan``."""

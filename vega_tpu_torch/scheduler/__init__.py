"""The local runtime's scheduler (the port's copy of vega_tpu/scheduler/
for local mode): the DAG scheduler that cuts stages at shuffle
boundaries (dag.py), its stages and tasks (stage.py, task.py), the
thread-pool backend (local_backend.py), the event bus and its metrics
(events.py) and the job server in front (jobserver.py)."""

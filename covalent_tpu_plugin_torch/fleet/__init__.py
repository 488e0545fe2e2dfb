"""Fleet pieces of the port: the fair work queue and the health monitor.

Own copies of ``covalent_tpu_plugin/fleet/queue.py`` and
``covalent_tpu_plugin/fleet/health.py``, which the replica sets of
``serving`` route with.  Pools, the fleet scheduler, the journal and
autoscaling are not ported yet (ROADMAP items 2c.4 and 2c.7, slice 5b).
"""

from .health import HEALTH, HealthMonitor
from .queue import DEFAULT_TENANT, FairWorkQueue, QueueFullError, WorkItem

__all__ = ["DEFAULT_TENANT", "FairWorkQueue", "HEALTH", "HealthMonitor", "QueueFullError",
           "WorkItem"]

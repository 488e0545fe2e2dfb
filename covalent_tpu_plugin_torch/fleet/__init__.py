"""Fleet pieces of the port: the fair work queue, the health monitor, the
control-plane journal and crash recovery.

Own copies of ``covalent_tpu_plugin/fleet/queue.py``, ``health.py``,
``journal.py`` and ``recovery.py``.  The replica sets of ``serving`` route
with the queue and the monitor; the executor and the serving supervisors
write the journal (opt-in: ``COVALENT_TPU_JOURNAL_DIR``), and
:func:`recover` re-adopts what a dead dispatcher left running.  Pools, the
fleet scheduler and autoscaling are not ported yet (ROADMAP item 2c.7 and
slice 5b).
"""

from . import journal
from .health import HEALTH, HealthMonitor
from .journal import Journal, JournalState
from .queue import DEFAULT_TENANT, FairWorkQueue, QueueFullError, WorkItem
from .recovery import RecoveryReport, recover

__all__ = ["DEFAULT_TENANT", "FairWorkQueue", "HEALTH", "HealthMonitor", "Journal",
           "JournalState", "QueueFullError", "RecoveryReport", "WorkItem", "journal",
           "recover"]

"""Fleet pieces of the port: the fair work queue, the health monitor, the
control-plane journal, crash recovery and named pools.

Own copies of ``covalent_tpu_plugin/fleet/queue.py``, ``health.py``,
``journal.py``, ``recovery.py`` and ``pools.py``.  The replica sets of
``serving`` route with the queue and the monitor; the executor and the
serving supervisors write the journal (opt-in: ``COVALENT_TPU_JOURNAL_DIR``),
and :func:`recover` re-adopts what a dead dispatcher left running.  A
:class:`Pool` is a serving target whose sessions pin its capacity slots.
The fleet scheduler, leases and autoscaling are not ported yet (slice 5b,
ROADMAP Queue 1 item 6).
"""

from . import journal
from .health import HEALTH, HealthMonitor
from .journal import Journal, JournalState
from .pools import POOL_SLOTS, Pool, PoolRegistry, PoolSpec, parse_pool_specs
from .queue import DEFAULT_TENANT, FairWorkQueue, QueueFullError, WorkItem
from .recovery import RecoveryReport, recover

__all__ = ["DEFAULT_TENANT", "FairWorkQueue", "HEALTH", "HealthMonitor", "Journal",
           "JournalState", "POOL_SLOTS", "Pool", "PoolRegistry", "PoolSpec", "QueueFullError",
           "RecoveryReport", "WorkItem", "journal", "parse_pool_specs", "recover"]

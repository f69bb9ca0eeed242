"""Control plane: the process lifecycle (autosave, orderly save and
shutdown), shard liveness (``Heartbeat``), the daily merge, the repair
rebuild and ``rebalance``.

Port of ``open_source_search_engine_tpu/control/``.
"""

from .process import Heartbeat, Process

__all__ = ["Heartbeat", "Process"]

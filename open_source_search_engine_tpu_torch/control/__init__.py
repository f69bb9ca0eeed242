"""Control plane: the process lifecycle (autosave, orderly save and
shutdown), the daily merge and the repair rebuild.

Port of ``open_source_search_engine_tpu/control/`` without the cluster's
liveness prober (``Heartbeat``, ``make_rpc_probe``) and ``rebalance``,
which come with the multi-process cluster.
"""

from .process import Process

__all__ = ["Process"]

"""Launcher master: multi-node rendezvous + rerank, the counterpart of
``paddle_tpu/distributed/launch/master.py``.

Analog of upstream's launch masters (launch/controllers/master.py:73
HTTPMaster — rank-0 KV — and :186 ETCDMaster): here the KV is the
port's TCPStore (``store.py`` over csrc/tcp_store.cc), which the node on
the master endpoint serves. Every (re)launch epoch, each node registers its endpoint and
worker count; registration order fixes node ranks for that epoch, so a
node set that changed across restarts is re-ranked automatically — the
ElasticManager rerank behavior (fleet/elastic/manager.py:125) collapsed
onto the store.
"""
from __future__ import annotations

import json
import time
from typing import List, Tuple


class Master:
    """One node's view of the job-level rendezvous."""

    def __init__(self, endpoint: str, job_id: str, is_master: bool,
                 world_nodes: int, timeout: float = 300.0):
        from ..store import TCPStore
        host, port = endpoint.rsplit(":", 1)
        self.job_id = job_id
        self.world_nodes = world_nodes
        self.store = TCPStore(host, int(port), is_master=is_master,
                              world_size=world_nodes, timeout=timeout)

    # ------------------------------------------------------------ epochs
    def register_node(self, epoch: int, node_endpoint: str,
                      nproc: int) -> int:
        """Register this node for `epoch`; returns its node rank
        (registration order — rerank happens for free on relaunch)."""
        base = f"__launch/{self.job_id}/{epoch}"
        node_rank = int(self.store.add(f"{base}/nodes", 1)) - 1
        self.store.set(f"{base}/node/{node_rank}",
                       json.dumps({"ep": node_endpoint,
                                   "nproc": nproc}).encode())
        return node_rank

    def wait_peers(self, epoch: int) -> List[Tuple[str, int]]:
        """Block until every node registered; returns
        [(endpoint, nproc)] in node-rank order."""
        base = f"__launch/{self.job_id}/{epoch}"
        deadline = time.time() + 300
        while time.time() < deadline:
            if int(self.store.add(f"{base}/nodes", 0)) >= self.world_nodes:
                break
            time.sleep(0.05)
        out = []
        for r in range(self.world_nodes):
            info = json.loads(self.store.get(f"{base}/node/{r}").decode())
            out.append((info["ep"], int(info["nproc"])))
        return out

    def signal_failure(self, epoch: int):
        """A node whose pod died tells everyone to tear down + restart
        (the watch-loop broadcast of controllers/controller.py:87)."""
        self.store.add(f"__launch/{self.job_id}/{epoch}/failcnt", 1)

    def poll_failure(self, epoch: int) -> bool:
        try:
            return self.store.add(
                f"__launch/{self.job_id}/{epoch}/failcnt", 0) > 0
        except Exception:
            return False

    def signal_done(self, epoch: int):
        self.store.add(f"__launch/{self.job_id}/{epoch}/donecnt", 1)

    def poll_done(self, epoch: int) -> int:
        try:
            return int(self.store.add(
                f"__launch/{self.job_id}/{epoch}/donecnt", 0))
        except Exception:
            return 0

    def ack_exit(self, is_owner: bool, timeout: float = 60.0):
        """Store-owner teardown fence: every node acks having observed
        job completion; the node serving the store waits for all acks
        before returning (otherwise a peer's final poll races the dead
        server — same two-phase shape as rpc.shutdown)."""
        self.store.add(f"__launch/{self.job_id}/exitack", 1)
        if is_owner:
            deadline = time.time() + timeout
            while time.time() < deadline:
                if int(self.store.add(f"__launch/{self.job_id}/exitack",
                                      0)) >= self.world_nodes:
                    return
                time.sleep(0.05)


def global_endpoints(peers: List[Tuple[str, int]],
                     base_port: int = 0) -> List[str]:
    """Flatten per-node (endpoint, nproc) into the global trainer
    endpoint list (PADDLE_TRAINER_ENDPOINTS)."""
    out = []
    for ep, nproc in peers:
        host = ep.rsplit(":", 1)[0]
        port = int(ep.rsplit(":", 1)[1])
        for i in range(nproc):
            out.append(f"{host}:{port + i}")
    return out

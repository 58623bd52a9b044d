"""Data-center topology model: nodes -> racks -> pods, link resources.

Mirrors the paper's evaluation fabric (Section 4 + Table 5): every node has a
NIC (100 GbE in the paper's cluster), local NVMe devices, racks have a
top-of-rack switch whose up-link is oversubscribed 3:1 (32 x 40G ports ->
320 Gb/s up-link), and a remote store (NFS) hangs off the data-center core.

Every link is a :class:`~repro_torch.core.simclock.Resource`; paths between
endpoints are resource lists handed to ``SimClock.transfer``.  Locality is a
first-class query (same node < same rack < same pod < cross-pod < remote),
because the placement engine (Requirement 3) optimises exactly this distance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from .simclock import Resource, SimClock

GB = 1e9
Gb = 1e9 / 8


@dataclass
class TopologyConfig:
    nodes_per_rack: int = 4
    racks_per_pod: int = 1
    pods: int = 1
    nic_bw: float = 100 * Gb              # 100 GbE per node (paper Table 2)
    tor_uplink_bw: float = 320 * Gb       # 32x40G ports, 3:1 oversub (paper 4.5)
    core_bw: float = 1280 * Gb            # DC core between TORs / pods
    nvme_bw_per_disk: float = 3.5 * GB    # Samsung 960 Pro-class read BW
    nvme_disks_per_node: int = 2          # paper: 2 NVMe per node for the cache
    remote_nic_bw: float = 1.05 * GB      # measured NFS aggregate (paper 4)
    remote_stream_bw: float = 161e6       # per-client NFS stream (Table 4: 1.23 Gb/s
    #                                       sent per job ~= 154 MB/s on the wire;
    #                                       161 MB/s of payload matches the 60-epoch
    #                                       duration of 14.90 h exactly)

    @property
    def total_nodes(self) -> int:
        return self.nodes_per_rack * self.racks_per_pod * self.pods


@dataclass
class Node:
    node_id: int
    rack_id: int
    pod_id: int
    nic_tx: Resource
    nic_rx: Resource
    nvme: Resource          # aggregate NVMe read/write queue for the node
    name: str = field(default="")

    def __post_init__(self):
        if not self.name:
            self.name = f"node{self.node_id}"

    def __hash__(self):
        return self.node_id

    def __eq__(self, other):
        return isinstance(other, Node) and other.node_id == self.node_id


class Topology:
    """Builds the resource graph and answers path/distance queries."""

    SAME_NODE, SAME_RACK, SAME_POD, CROSS_POD, REMOTE = range(5)

    def __init__(self, cfg: TopologyConfig, clock: SimClock):
        self.cfg = cfg
        self.clock = clock
        self.nodes: list[Node] = []
        self.rack_uplink_tx: dict[int, Resource] = {}
        self.rack_uplink_rx: dict[int, Resource] = {}
        t0 = clock.now  # a fabric built mid-sim starts its utilization clock here
        self.core = Resource("core", cfg.core_bw, created_at=t0)
        self.remote_nic = Resource("remote_nic", cfg.remote_nic_bw, created_at=t0)

        nid = 0
        rid = 0
        for pod in range(cfg.pods):
            for _rack in range(cfg.racks_per_pod):
                self.rack_uplink_tx[rid] = Resource(
                    f"rack{rid}.up_tx", cfg.tor_uplink_bw, created_at=t0
                )
                self.rack_uplink_rx[rid] = Resource(
                    f"rack{rid}.up_rx", cfg.tor_uplink_bw, created_at=t0
                )
                for _n in range(cfg.nodes_per_rack):
                    self.nodes.append(
                        Node(
                            node_id=nid,
                            rack_id=rid,
                            pod_id=pod,
                            nic_tx=Resource(f"node{nid}.nic_tx", cfg.nic_bw, created_at=t0),
                            nic_rx=Resource(f"node{nid}.nic_rx", cfg.nic_bw, created_at=t0),
                            nvme=Resource(
                                f"node{nid}.nvme",
                                cfg.nvme_bw_per_disk * cfg.nvme_disks_per_node,
                                created_at=t0,
                            ),
                        )
                    )
                    nid += 1
                rid += 1

    # ------------------------------------------------------------------ queries
    def distance(self, a: Node, b: Node) -> int:
        if a.node_id == b.node_id:
            return self.SAME_NODE
        if a.rack_id == b.rack_id:
            return self.SAME_RACK
        if a.pod_id == b.pod_id:
            return self.SAME_POD
        return self.CROSS_POD

    def path(self, src: Node, dst: Node) -> list[Resource]:
        """Network path for bytes moving src -> dst (excludes disks)."""
        d = self.distance(src, dst)
        if d == self.SAME_NODE:
            return []
        if d == self.SAME_RACK:
            # TOR switching fabric is non-blocking within the rack
            return [src.nic_tx, dst.nic_rx]
        # crosses at least one TOR up-link pair
        return [
            src.nic_tx,
            self.rack_uplink_tx[src.rack_id],
            self.core,
            self.rack_uplink_rx[dst.rack_id],
            dst.nic_rx,
        ]

    def path_from_remote(self, dst: Node) -> list[Resource]:
        """NFS/object-store -> node: remote NIC, DC core, rack, node NIC."""
        return [
            self.remote_nic,
            self.core,
            self.rack_uplink_rx[dst.rack_id],
            dst.nic_rx,
        ]

    def rack_nodes(self, rack_id: int) -> list[Node]:
        return [n for n in self.nodes if n.rack_id == rack_id]

    def pod_nodes(self, pod_id: int) -> list[Node]:
        return [n for n in self.nodes if n.pod_id == pod_id]

    def node(self, node_id: int) -> Node:
        return self.nodes[node_id]

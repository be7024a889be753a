from repro_torch.data.partition import (
    DirichletPartition, IidPartition, LabelPartition, Partition,
    partition_dirichlet, partition_iid, partition_label,
)
from repro_torch.data.pipeline import (
    ArraySource, ClientBatch, ClientDataset, ClientFleet, batched,
    make_clients, make_fleet, shape_buckets,
)
from repro_torch.data.synthetic import (
    VirtualClassification, make_classification, make_lm_stream,
)

__all__ = [
    "Partition", "IidPartition", "LabelPartition", "DirichletPartition",
    "partition_dirichlet", "partition_iid", "partition_label",
    "ArraySource", "ClientBatch", "ClientDataset", "ClientFleet", "batched",
    "make_clients", "make_fleet", "shape_buckets",
    "VirtualClassification", "make_classification", "make_lm_stream",
]

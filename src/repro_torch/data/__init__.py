from repro_torch.data.partition import (
    DirichletPartition, IidPartition, LabelPartition, Partition,
    partition_dirichlet, partition_iid, partition_label,
)
from repro_torch.data.pipeline import (
    ArraySource, ClientDataset, ClientFleet, batched, make_clients,
    make_fleet,
)
from repro_torch.data.synthetic import (
    VirtualClassification, make_classification,
)

__all__ = [
    "Partition", "IidPartition", "LabelPartition", "DirichletPartition",
    "partition_dirichlet", "partition_iid", "partition_label",
    "ArraySource", "ClientDataset", "ClientFleet", "batched",
    "make_clients", "make_fleet",
    "VirtualClassification", "make_classification",
]

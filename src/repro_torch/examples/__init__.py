"""Example drivers of the port, run as modules:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.federated_nas_cifar [--device cpu] ...
    python -m repro_torch.examples.train_lm [--device cpu] [--supernet]

``fed_nas`` holds the harness they share (clients, the supernet API, the
real-time search and the paper's two baselines, the Pareto front, the
history file); ``train_lm`` trains a smoke-size LM through
``launch/train.py``.  All run on the CUDA card unless given
``--device cpu``.
"""

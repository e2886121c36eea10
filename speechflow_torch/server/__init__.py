"""The data plane: a data server process, its batch workers, and loaders in
the training processes (see ``server.py`` for the messages)."""

from speechflow_torch.server.client import DataClient, flatten_dict
from speechflow_torch.server.helpers import (
    LoaderBundle,
    find_free_port,
    get_dataset_iterator,
    init_data_loader,
    init_data_loader_distributed,
    init_data_loader_from_configs,
)
from speechflow_torch.server.loader import Batch, DataLoader
from speechflow_torch.server.proxy import Proxy
from speechflow_torch.server.server import DataServer, sample_key
from speechflow_torch.server.worker import BatchWorker, WorkerPool

__all__ = ["DataServer", "BatchWorker", "WorkerPool", "DataLoader", "Batch", "Proxy",
           "DataClient", "flatten_dict", "init_data_loader", "init_data_loader_distributed",
           "init_data_loader_from_configs", "get_dataset_iterator", "LoaderBundle",
           "find_free_port", "sample_key"]

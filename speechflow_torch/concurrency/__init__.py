from speechflow_torch.concurrency.process_worker import ProcessWorker

__all__ = ["ProcessWorker"]

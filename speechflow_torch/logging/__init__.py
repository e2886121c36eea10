from speechflow_torch.logging.server import (
    LoggingServer,
    attach_from_env,
    attach_socket_handler,
    profiler_event,
)
from speechflow_torch.logging.utils import log_to_file, trace

__all__ = ["LoggingServer", "attach_socket_handler", "attach_from_env", "profiler_event",
           "trace", "log_to_file"]

"""DataClient: the server's metadata without batches (counterpart of
``speechflow_tpu/server/client.py``): the pipeline info once, searched by
dotted keys (``find_info``, ``find_section``), and the queue's ``status``."""

from __future__ import annotations

import pickle
import typing as tp

from speechflow_torch.server import transport as T

__all__ = ["DataClient", "flatten_dict"]


def flatten_dict(d: tp.Mapping, parent: str = "", sep: str = ".") -> tp.Dict[str, tp.Any]:
    out: tp.Dict[str, tp.Any] = {}
    for k, v in d.items():
        key = f"{parent}{sep}{k}" if parent else str(k)
        if isinstance(v, tp.Mapping) and v:
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


class DataClient:
    def __init__(self, server_addr: str, authkey: bytes, timeout_s: float = 60.0):
        self.server_addr = server_addr
        self.timeout_s = timeout_s
        self._conn = T.connect(server_addr, authkey)
        header, frames = self._ask({"type": "info"})
        self.info: tp.Dict[str, tp.Any] = pickle.loads(frames[0])
        self.n_workers = header.get("n_workers", 1)

    def _ask(self, msg: dict):
        T.send(self._conn, msg)
        if not self._conn.poll(self.timeout_s):
            raise TimeoutError(f"data server at {self.server_addr} did not answer "
                               f"{msg['type']}")
        return T.recv(self._conn)

    def status(self) -> dict:
        return self._ask({"type": "status"})[0]

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass

    def __enter__(self) -> "DataClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def find_info(self, name: str, default: tp.Any = None,
                  section: tp.Optional[str] = None) -> tp.Any:
        """The first non-empty value whose dotted key ends with ``name``."""
        src = self.info if section is None else self.info.get(section, {})
        for key, value in flatten_dict(src).items():
            if key.endswith(name) and value not in (None, {}):
                return value
        return default

    def find_section(self, name_or_value: str, default: tp.Any = None) -> tp.Any:
        """The subtree named ``name_or_value`` anywhere in the info, or the
        subtree that holds it as a value."""
        if name_or_value in self.info:
            return self.info[name_or_value]
        path: tp.Optional[tp.List[str]] = None
        for key, value in flatten_dict(self.info).items():
            parts = key.split(".")
            if name_or_value in parts:
                path = parts[: parts.index(name_or_value) + 1]
            elif isinstance(value, str) and value == name_or_value:
                path = parts[:-1]
        if not path:
            return default
        node: tp.Any = self.info
        for name in path:
            if not isinstance(node, tp.Mapping) or name not in node:
                return default
            node = node[name]
        return node

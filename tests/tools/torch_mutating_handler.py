"""Test-only handler of the port that mutates a sample's array in place: a data
server's workers must hand their handlers writable samples (the JAX package's
``tests/tools/mutating_handler.py``, for ``speechflow_torch``); and a collate of
the samples' payloads. A data config's ``preproc.imports`` lists this module."""

import numpy as np

from speechflow_torch.data.collate import COLLATES
from speechflow_torch.data.processors import handler


@handler(inputs={"payload"}, outputs={"payload"})
def mutate_payload_inplace(ds):
    arr = ds.additional["payload"]
    arr += 1.0  # in place: needs a writable array
    ds.additional["payload_sum"] = float(np.sum(arr))
    return ds


class PayloadCollate:
    """The samples' payloads stacked, and their sums where a handler wrote them."""

    def __call__(self, samples):
        out = {"payload": np.stack([s.additional["payload"] for s in samples])}
        if all("payload_sum" in s.additional for s in samples):
            out["payload_sum"] = np.asarray([s.additional["payload_sum"] for s in samples])
        return out


COLLATES["PayloadCollate"] = PayloadCollate

"""Self-supervised speech features (counterpart of ``speechflow_tpu.models.ssl``)."""

from speechflow_torch.models.ssl.cpc import CPCModel, CPCParams, cpc_infonce_loss, train_cpc

__all__ = ["CPCParams", "CPCModel", "cpc_infonce_loss", "train_cpc"]

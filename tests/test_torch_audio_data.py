"""The port's audio data path and checkpoints against the JAX package's:
``configs/vocoder_data_24khz.yml`` over ``tests/data/SEGS`` (with a fixed
``random_chunk`` seed) gives the same files, singleton states and collated
waveforms; a checkpoint the port writes loads back equal (weights, both
optimizers, step), into the vocoder interface, and into a JAX ``Vocos``
through ``nnx.replace_by_pure_dict`` with JAX's output."""

import copy
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, load_nnx_state
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.scripts.common import experiment_saver
from speechflow_torch.scripts.train_vocoder import configs
from speechflow_torch.training.saver import ExperimentSaver

torch.set_num_threads(1)
SEGS = Path(__file__).resolve().parent / "data" / "SEGS"


def _data_cfg(value_select: str = "default") -> dict:
    cfg = configs(value_select, data_root=SEGS)[1]
    cfg["preproc"]["pipe_cfg"]["random_chunk"]["seed"] = 7
    return cfg


@pytest.mark.parametrize("value_select", ["default", "debug"])
def test_audio_pipeline_matches_jax(value_select):
    from speechflow_tpu.data.core.components import DataPipeline as JPipeline
    from speechflow_tpu.io import Config

    cfg = _data_cfg(value_select)
    jp = JPipeline(Config(copy.deepcopy(cfg))).init_components()
    tp_ = DataPipeline.from_config(cfg)
    ji = jp.get_info()
    assert tp_.get_info()["singletons"] == ji["singletons"]
    assert tp_.get_info()["dataset_sizes"] == ji["dataset_sizes"]
    for subset in ("train", "test"):
        assert [s.file_path for s in tp_.datasets[subset]] == jp[subset].dataset.get_file_list()
        for _ in range(3):
            jb = jp[subset].sample_batch(4).collated_samples
            tb = tp_.sample_batch(subset, 4)
            np.testing.assert_array_equal(tb.waveform, jb.waveform)
            np.testing.assert_array_equal(tb.waveform_lengths, jb.waveform_lengths)
            np.testing.assert_array_equal(tb.speaker_id, jb.speaker_id)


def test_loader_workers_serve_the_pipeline_batches():
    """Two spawned worker processes give the batches this process would."""
    cfg = _data_cfg("debug")
    ref = DataPipeline.from_config(cfg)
    loader = DataPipeline.from_config(cfg).loader("train", 2, n_workers=2, prefetch_factor=1)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(loader.next_batch().waveform,
                                          ref.sample_batch("train", 2).waveform)
    finally:
        loader.close()


def _gan(tmp_path):
    """A port GAN trainer of the debug recipe with one step taken, and its saver."""
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.scripts.common import optimizer_config
    from speechflow_torch.training.gan_trainer import GANTrainer

    model_cfg, data_cfg = configs("debug", data_root=SEGS)
    saver = experiment_saver(model_cfg, data_cfg, tmp_path)
    torch.manual_seed(0)
    params = VocosParams.create(model_cfg["model"])
    gan = GANTrainer(Vocos(params), VocoderDiscriminator(**model_cfg["discriminator"]),
                     vocoder_gen_criterion(n_mels=params.n_mels, **model_cfg["loss"]),
                     vocoder_disc_criterion(), VocoderBatchProcessor(),
                     gen_optimizer=optimizer_config(model_cfg),
                     disc_optimizer=optimizer_config(model_cfg), saver=saver)
    saver.to_save["model_params"] = dataclasses.asdict(params)
    rng = np.random.default_rng(0)
    gan.training_step({"waveform": (0.1 * rng.normal(size=(2, 4096))).astype(np.float32)})
    return gan, saver


def test_checkpoint_round_trip(tmp_path):
    gan, saver = _gan(tmp_path)
    path = gan.save_checkpoint()
    assert path.name == "step_000000001" and gan.save_checkpoint() == path  # idempotent
    assert ExperimentSaver.get_last_checkpoint(saver.expr_path) == path
    tree, payload = ExperimentSaver.load_checkpoint(path)
    assert tree["step"] == 1 and "model_config_text" in payload and "versions" in payload

    again, _ = _gan(tmp_path / "other")
    again.load_checkpoint(path)
    assert again.global_step == 1
    for a, b in ((gan.generator, again.generator), (gan.discriminator, again.discriminator)):
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), n
    for a, b in ((gan.gen_opt, again.gen_opt), (gan.disc_opt, again.disc_opt)):
        assert (a.count, a.mini_step) == (b.count, b.mini_step)
        sa, sb = a.base.state_dict()["state"], b.base.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for k in sa:
            for key in sa[k]:
                assert torch.equal(torch.as_tensor(sa[k][key]), torch.as_tensor(sb[k][key]))


def test_checkpoint_loads_into_the_interface_and_into_jax(tmp_path):
    """The saved generator tree is the JAX package's layout: it fills a JAX Vocos
    strictly and gives JAX's waveform; the port's interface gives the same."""
    from speechflow_tpu.models.vocoder import Vocos as JVocos
    from speechflow_tpu.models.vocoder import VocosParams as JParams

    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk

    gan, _ = _gan(tmp_path)
    tree, payload = ExperimentSaver.load_checkpoint(gan.save_checkpoint())
    jm = JVocos(JParams.create(payload["model_params"]), rngs=nnx.Rngs(0))
    state = nnx.state(jm, nnx.Not(nnx.RngState))
    nnx.replace_by_pure_dict(state, tree["model"]["generator"])
    nnx.update(jm, state)
    wav = (0.1 * np.random.default_rng(1).normal(size=(1, 4096))).astype(np.float32)
    ref = np.asarray(jm({"waveform": jnp.asarray(wav)}))
    with torch.no_grad():
        ours = gan.generator.eval()({"waveform": torch.from_numpy(wav)}).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4 * max(1.0, np.abs(ref).max()))
    vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cpu")
    out = vi.resynthesize(AudioChunk(data=wav[0], sr=24000)).data
    np.testing.assert_allclose(out, np.clip(ref[0], -1, 1), atol=1e-4)


def test_port_loader_refuses_an_orbax_checkpoint(tmp_path):
    """The port's loader reads an orbax checkpoint the JAX saver wrote: the GAN
    tree comes back bit for bit (dict keys as orbax stores them, the step a 0-d
    array), the payload too, and it fills a port GAN; resuming from it is refused
    (saved without its optimizer state, a resume would restart the moments from
    zero); a directory of neither layout is refused."""
    from speechflow_tpu.training.saver import ExperimentSaver as JSaver

    gan, _ = _gan(tmp_path)
    tree, payload = ExperimentSaver.load_checkpoint(gan.save_checkpoint())
    js = JSaver(tmp_path / "jax", expr_suffix="voc")
    path = js.save(1, tree["model"], extra=payload)
    ours, ours_payload = ExperimentSaver.load_checkpoint(path)
    ref, ref_payload = JSaver.load_checkpoint(path)
    assert ours_payload == ref_payload and set(ours) == set(ref) == {"model", "step"}
    assert ours["step"].shape == () and int(ours["step"]) == 1
    for (k, a), (k2, b) in zip(sorted(flatten_nnx(ours["model"]).items()),
                               sorted(flatten_nnx(ref["model"]).items())):
        assert k == k2
        np.testing.assert_array_equal(a, b, err_msg=k)
    again, _ = _gan(tmp_path / "other")
    load_nnx_state(again.generator, ours["model"]["generator"])
    for (n, p), q in zip(gan.generator.named_parameters(), again.generator.parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="no optimizer state"):
        again.load_checkpoint(path)
    (tmp_path / "step_000000001").mkdir()
    with pytest.raises(FileNotFoundError, match="orbax"):
        ExperimentSaver.load_checkpoint(tmp_path / "step_000000001")



"""Data-parallel training of the acoustic model against one process and
against JAX (CPU, f32, two gloo ranks spawned under JAX's environment contract;
the vocoder GAN's in ``test_torch_distributed_gan.py``).

The acoustic model (the ``debug`` preset of ``configs/tts_model.yml`` with the
CFM decoder, seeded random weights, dropout off, the CFM's draws injected)
takes ``Trainer`` steps with ``use_mesh`` on two ranks, each on its
half of one global batch as the data server cuts it (the collated batch's rows;
rank 0 holds the long utterances, rank 1 the short). Checked: the losses and the
weights against the port's one process on the whole batch (1e-6), and against
JAX's single-process trainer on the same global batch (the tolerances of
``test_torch_tts_train.py``'s step test);
``broadcast_bytes``; ``init_distributed`` from the environment, and a no-op
without it. Every rank is joined within 60 s and killed if it is alive.
"""

import copy

import numpy as np
import pytest
import torch
from flax import nnx

from speechflow_torch.convert import flatten_nnx, nnx_from_module
from speechflow_torch.models.tts.model import ParallelTTSModel, ParallelTTSParams
from speechflow_torch.parallel import distributed as D
from speechflow_torch.parallel import make_mesh
from speechflow_torch.scripts import train_tts
from speechflow_torch.server.worker import take_rows
from tests import torch_dp_ranks as R
from tests.torch_parity import cfm_train_draws, jax_tts_model, no_dropout, port, randomize

torch.set_num_threads(1)
WORLD = 2
EXACT = 1e-6      # data parallel against one process: losses, and weights of the model's scale
MODEL_TOL = 2e-4  # test_torch_tts_train.py: the acoustic model's losses against JAX's
B, N, N_MELS = 4, 13, 16
LENS = np.array([13, 12, 7, 5])  # rank 0 holds the two long utterances, rank 1 the short
STEPS = 3
SGD = dict(method="sgd", lr=0.01, lr_schedule="ConstLR", grad_clip=1.0, betas=(0.0, 0.999))


def _tts_params() -> dict:
    model = dict(train_tts.configs("debug")[0]["model"], n_symbols=20, n_speakers=3,
                 n_langs=2, n_mels=N_MELS, decoder_type="cfm")
    model["variances"] = [dict(v) for v in model["variances"]]
    return model


def _global_batch() -> dict:
    """A collated batch of ``B`` utterances, zero past each one's length, padded
    to the longest (tokens and frames)."""
    return R.tts_batch(B, N, LENS, N_MELS)


def _rank_slice(arrays: dict, rows: slice) -> dict:
    """A rank's part of the collated global batch, as the data server cuts it:
    its rows, padded as the whole batch is."""
    return take_rows(arrays, list(range(B))[rows], B)


def _draw_rows(draw, rows: slice, t: int) -> tuple:
    u, z, drop_c, drop_e = (x.numpy() for x in draw)
    return u[rows], np.ascontiguousarray(z[rows, :t]), drop_c[rows], drop_e[rows]


def _split(world: int = WORLD):
    per = B // world
    return [slice(r * per, (r + 1) * per) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks over both jobs; the one-process reference; JAX's steps."""
    from speechflow_tpu.models.tts import TTSBatchProcessor as JBP
    from speechflow_tpu.models.tts import TTSCriterion as JCrit
    from speechflow_tpu.training import Trainer as JTrainer
    from speechflow_tpu.training.optimizer import OptimizerConfig as JOpt
    from speechflow_tpu.training.trainer import TrainerConfig as JCfg

    params = _tts_params()
    jm = randomize(jax_tts_model(params), seed=11)
    tm = port(ParallelTTSModel(ParallelTTSParams.create(params)), jm)
    no_dropout(jm, tm)
    arrays = _global_batch()
    draws = cfm_train_draws(jm, B, arrays["mel"].shape, n=STEPS)
    loss = train_tts.configs("debug")[0]["loss"]
    adam = train_tts.configs("debug")[0]["optimizer"]
    rows = _split()
    t = arrays["mel"].shape[1]
    tts = dict(kind="tts", params=params, loss=loss, weights=R._weights(tm),
               batches=[[_rank_slice(arrays, r)] * STEPS for r in rows],
               draws=[[_draw_rows(d, r, t) for d in draws] for r in rows])
    whole = dict(tts, batches=[[arrays] * STEPS],
                 draws=[[_draw_rows(d, slice(None), t) for d in draws]])
    world = R.start_world(WORLD, {"tts_sgd": dict(tts, opt=SGD), "tts_adam": dict(tts, opt=adam),
                                  "data": dict(kind="dataplane", n=30, batch=3, batches=4)},
                          tmp_path_factory.mktemp("dp"))
    try:  # the references while the ranks run
        one = R.tts_steps(dict(whole, opt=SGD), 0)
        jt = JTrainer(jm, JCrit(**loss), JBP(), JOpt.from_config(adam), JCfg(max_steps=10))
        jax_losses = [{k: float(v) for k, v in jt.training_step(arrays).items()}
                      for _ in range(STEPS)]
    finally:
        ranks = R.join_world(world)
    return dict(ranks=ranks, one=one, jax_losses=jax_losses,
                jax_weights=flatten_nnx(nnx.to_pure_dict(nnx.state(jm, nnx.Param))),
                before=R._weights(tm), params=params)


def _losses_equal(got: list, ref: list, rtol: float) -> None:
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-7, err_msg=k)


def _weights_equal(got: dict, ref: dict, before: dict, rtol: float, what: str) -> None:
    """Every weight within ``rtol`` of the model's largest weight, and the steps
    moved the model."""
    assert set(got) == set(ref)
    scale = max(np.abs(v).max() for v in ref.values())
    err = max(np.abs(got[k] - ref[k]).max() for k in ref)
    assert err <= rtol * scale, f"{what}: {err} of {scale}"
    assert any(not np.array_equal(ref[k], before[k]) for k in ref), what


def test_ranks_join_through_the_environment_contract(runs):
    assert [r["init"] for r in runs["ranks"]] == [(0, WORLD), (1, WORLD)]
    assert {r["backend"] for r in runs["ranks"]} == {"gloo"}
    assert [r["broadcast"] for r in runs["ranks"]] == [b"rank 0's bytes"] * WORLD


def test_rank_0s_data_server_feeds_every_rank(runs):
    """``init_data_loader_distributed``: rank 0 hosts the server, the address reaches
    rank 1 through the process group, and each step's global batch of 2 x 3 is the
    sampler's next six samples, rank 0's half first: disjoint over the ranks. Each
    rank's collated 64 x 64 payloads are the rows of its own samples."""
    a, b = (r["data"] for r in runs["ranks"])
    assert a["hosts_server"] and not b["hosts_server"]
    steps = [[int(k) for k in x + y] for x, y in zip(a["keys"], b["keys"])]
    assert steps == [list(range(6 * k, 6 * k + 6)) for k in range(4)]
    for rank in (a, b):
        for keys, payload in zip(rank["keys"], rank["payloads"]):
            want = np.stack([np.full((64, 64), float(k), np.float32) for k in keys])
            np.testing.assert_array_equal(payload, want)


def test_init_distributed_is_a_noop_without_the_contract(monkeypatch):
    for k in (D.ENV_COORDINATOR, D.ENV_NUM_PROCESSES, D.ENV_PROCESS_ID):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed() == (0, 1)
    assert not D.is_distributed() and D.process_index() == 0 and D.backend() is None
    assert D.broadcast_bytes(b"x") == b"x"
    assert make_mesh().size == 1
    with D.data_parallel_step():
        count = torch.tensor(7.0)
        assert D.global_count(count) is count


@pytest.mark.parametrize("seen, cards, device, want", [
    # one host of 8 cards, 8 ranks: each its own card
    (["a|*"] * 8, 8, "cuda", [("nccl", 8, r) for r in range(8)]),
    # two hosts of 8 cards, ranks interleaved over them: 8 a host, nccl
    (["a|*", "b|*"] * 8, 8, "cuda", [("nccl", 8, r // 2) for r in range(16)]),
    # two ranks on a host of one card: gloo
    (["a|*"] * 2, 1, "cuda", [("gloo", 2, 0), ("gloo", 2, 1)]),
    # each rank shown one card of its host: one rank a card
    (["a|0", "a|1"], 1, "cuda", [("nccl", 1, 0), ("nccl", 1, 0)]),
    # the CPU, or no card: gloo
    (["a|*"] * 2, 8, "cpu", [("gloo", 2, 0), ("gloo", 2, 1)]),
    (["a|*"] * 2, 0, None, [("gloo", 2, 0), ("gloo", 2, 1)]),
])
def test_backend_from_the_ranks_that_share_cards(seen, cards, device, want):
    """nccl wherever the ranks that see one set of cards have a card each, decided
    from what every rank sees (not the world size), and the card of each rank."""
    got = []
    for rank in range(len(seen)):
        n, index = D.local_placement(seen, rank)
        got.append((D.choose_backend(device, n, cards), n, index))
    assert got == want


def test_tts_steps_equal_one_process(runs):
    """SGD steps: the ranks' logged losses and weights are one process's on the
    whole batch, and the two ranks' weights are equal."""
    a, b = (r["tts_sgd"] for r in runs["ranks"])
    ref = runs["one"]
    _losses_equal(a["losses"], ref["losses"], EXACT)
    assert a["losses"] == b["losses"]
    assert all(np.array_equal(a["weights"][k], b["weights"][k]) for k in a["weights"])
    _weights_equal(a["weights"], ref["weights"], runs["before"], EXACT, "tts")


def test_tts_steps_match_jax(runs):
    """The recipe's AdamW (WarmupCosine, clip 1.0; the first step at lr 0): the
    ranks' losses against JAX's single-process trainer on the global batch
    within ``MODEL_TOL``, and the weights within two Adam steps of JAX's."""
    a = runs["ranks"][0]["tts_adam"]
    _losses_equal(a["losses"], runs["jax_losses"], MODEL_TOL)
    model = ParallelTTSModel(ParallelTTSParams.create(runs["params"]))
    R._load(model, a["weights"], "cpu")
    got, ref = flatten_nnx(nnx_from_module(model)), runs["jax_weights"]
    lr = train_tts.configs("debug")[0]["optimizer"]["lr"]
    assert set(got) == set(ref)
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 2 * lr, k

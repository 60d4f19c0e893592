"""The port's hyper-parameter search against the JAX package's, on the CPU.

The annealer's visited sequence for a seed, token contrast, the positive
masks, the pos-win reward and ``RewardEvaluator`` with its memo files
(``tests/test_search.py``'s cases, each also held against the JAX
function on the same seeded inputs), then both search CLIs and both
token-contrast CLIs end to end at ``--tiny --scorer itc`` on one tiny
LAVIS-layout checkpoint (``--checkpoint``, so both packages score with the
same weights) over a synthetic VOC directory: the same best config, the
same visited configs, scores within 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_fake_voc
from pnp_ovss_tpu.cli import search as jax_search_cli
from pnp_ovss_tpu.cli import token_contrast as jax_tc_cli
from pnp_ovss_tpu.search import reward as jax_reward
from pnp_ovss_tpu_torch.cli import search as search_cli
from pnp_ovss_tpu_torch.cli import token_contrast as tc_cli
from pnp_ovss_tpu_torch.search.optimizer import (
    RandomAnnealingOptimizer, SearchSpace, run_search,
)
from pnp_ovss_tpu_torch.search.reward import (
    RewardEvaluator, build_pos_masks, pos_win_reward, token_contrast,
)
from tests.test_torch_cli import _checkpoint


def _bumpy(p):
    """A score with many local optima, so acceptance draws matter."""
    return float(np.sin(3.1 * p["layer"] + 1.7 * p["head"])
                 - abs(p["min_att"] - 0.25))


@pytest.mark.parametrize("seed", [1164005944, 3])
def test_run_search_visits_the_jax_sequence(seed):
    got = run_search(_bumpy, n_iter=34, seed=seed)
    want = jax_search_cli.run_search(_bumpy, n_iter=34, seed=seed)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2] and len(got[2]) == 34


def test_optimizer_finds_peak():
    space = SearchSpace({"layer": list(range(1, 13)),
                         "head": list(range(12)),
                         "min_att": [0.05 * i for i in range(1, 10)]})

    def score(p):
        return -((p["layer"] - 8) ** 2) - (p["head"] - 9) ** 2 - abs(
            p["min_att"] - 0.25)

    opt = RandomAnnealingOptimizer(space, seed=7)
    best, _ = opt.search(score, n_iter=200)
    assert best["layer"] in (7, 8, 9) and abs(best["head"] - 9) <= 1
    assert len(opt.history) == 200


def test_token_contrast_matches_jax():
    m = np.ones((1, 3, 4, 4), np.float32)
    tc, std = token_contrast(torch.from_numpy(m))
    np.testing.assert_allclose(tc, 1.0, rtol=1e-5)
    np.testing.assert_allclose(std, 0.0, atol=1e-5)
    m2 = np.zeros((1, 2, 1, 2), np.float32)
    m2[0, 0, 0, 0] = m2[0, 1, 0, 1] = 1
    np.testing.assert_allclose(token_contrast(torch.from_numpy(m2))[0], 0.5,
                               rtol=1e-5)
    x = np.random.RandomState(0).rand(3, 5, 7, 7).astype(np.float32)
    x[1, 2] = 0  # an empty map
    got = token_contrast(torch.from_numpy(x))
    want = jax_reward.token_contrast(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_pos_win_reward_matches_jax():
    probs = np.asarray([[0.9, 0.1], [0.3, 0.6], [0.5, 0.2], [0.1, 0.7]])
    got = pos_win_reward(probs, 2)
    assert got[1] == 1  # 0.9 > 0.5 but 0.6 < 0.7
    assert got == jax_reward.pos_win_reward(probs, 2)


@pytest.mark.parametrize("min_att", [0.25, 0.5])
def test_build_pos_masks_matches_jax(min_att):
    maps = np.random.RandomState(0).rand(3, 7, 7).astype(np.float32)
    image = np.random.RandomState(1).rand(28, 30, 3).astype(np.float32)
    got = build_pos_masks(maps, image, min_att)
    want = jax_reward.build_pos_masks(maps, image, min_att)
    assert got[0].shape == (3, 28, 30, 3) and got[1].shape == (3, 24, 24)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    masked0, _ = build_pos_masks(np.zeros((1, 7, 7), np.float32), image, 0.5)
    assert np.abs(masked0).sum() == 0


def _scorer(images, texts):
    """Deterministic in the images: the positives' mass decides."""
    n = len(images)
    mass = np.abs(images).reshape(n, -1).mean(1)
    out = np.full((n, len(texts)), 0.1)
    for i in range(n):
        out[i, i % len(texts)] = 0.2 + mass[i]
    return out / out.sum(1, keepdims=True)


@pytest.mark.parametrize("scale", [False, True])
def test_reward_evaluator_matches_jax(tmp_path, scale):
    """Same provider and scorer: the same reward, the same memo file and
    the same token-contrast JSONs; a second call reads the memo."""
    rng = np.random.RandomState(0)
    items = [(f"img{i}", (rng.rand(2 + i, 7, 7).astype(np.float32),
                          ["dog", "cat", "sky"][: 2 + i],
                          rng.randn(28, 28, 3).astype(np.float32)))
             for i in range(2)]
    calls = []

    def provider(layer, head):
        calls.append((layer, head))
        yield from items

    cfg = {"layer": 8, "head": 9, "min_att": 0.25}
    outs = {}
    for name, cls in (("port", RewardEvaluator),
                      ("jax", jax_reward.RewardEvaluator)):
        ev = cls(provider, _scorer, cache_dir=str(tmp_path / name / "c"),
                 scale_by_token_contrast=scale,
                 token_contrast_dir=str(tmp_path / name / "tc"))
        outs[name] = (ev(cfg), ev(cfg))
    assert calls == [(8, 9), (8, 9)]  # the memo served each second call
    assert outs["port"][0] == outs["port"][1]
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], rtol=1e-5)
    memo = "c/layer8_head9/reward_metric_dict_attthresh25.json"
    got = json.loads((tmp_path / "port" / memo).read_text())
    want = json.loads((tmp_path / "jax" / memo).read_text())
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-5)
    tc = "tc/max_att_block_num8_atthead9_withatt25/Token_contrast_sum"
    for f in os.listdir(tmp_path / "jax" / tc):
        a = json.loads((tmp_path / "port" / tc / f).read_text())
        b = json.loads((tmp_path / "jax" / tc / f).read_text())
        assert list(a) == list(b)
        np.testing.assert_allclose(list(a.values()), list(b.values()),
                                   rtol=1e-5, atol=1e-6)


def _strong_checkpoint(root):
    """The tiny LAVIS-layout checkpoint with its matrices scaled by 20
    (std 0.4, about 1/sqrt(fan_in) at width 32), so that GradCAM maps
    reach the search's thresholds 0.05-0.45 and rewards are not all 0."""
    sd = torch.load(_checkpoint(root / "model.pth"))["model"]
    sd = {k: v * 20 if v.ndim == 2 and k.endswith("weight")
          and "embeddings" not in k else v for k, v in sd.items()}
    torch.save({"model": sd}, root / "strong.pth")
    return str(root / "strong.pth")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("search")
    write_fake_voc(str(root / "voc"), 4, seed=3)
    return dict(root=root, home=str(root / "voc"),
                ckpt=_strong_checkpoint(root))


def _search_args(voc, out, mode):
    return ["--data_type", "voc", "--home_dir", voc["home"], "--save_path",
            str(voc["root"] / out), "--tiny", "--layer", "1-2", "--n_iter",
            "5", "--limit", "3", "--scorer", "itc", "--checkpoint",
            voc["ckpt"], "--search", mode]


@pytest.mark.parametrize("mode", ["Wsupervised", "Unsupervised"])
def test_search_cli_matches_the_jax_cli(voc, mode):
    best, score = jax_search_cli.main(_search_args(voc, f"jax_{mode}", mode))
    got = search_cli.main(_search_args(voc, f"port_{mode}", mode) +
                          ["--device", "cpu"])
    assert got["best"] == best
    assert got["score"] == pytest.approx(score, rel=1e-5, abs=1e-6)
    assert len(got["history"]) == 5 and len(got["ensemble_s"]) == 3
    if mode == "Wsupervised":  # Unsupervised scores one class, whose
        # softmax over one text is 1 for the positive and negative alike.
        assert any(s > 0 for _, s in got["history"])
    assert 1 <= len(got["evaluation_s"]) <= 5
    memo = f"Search_{mode}_voc"
    assert sorted(os.listdir(voc["root"] / f"port_{mode}" / memo)) == \
        sorted(os.listdir(voc["root"] / f"jax_{mode}" / memo))


def test_token_contrast_cli_matches_the_jax_cli(voc):
    common = ["--data_type", "voc", "--home_dir", voc["home"], "--tiny",
              "--limit", "3", "--checkpoint", voc["ckpt"]]
    want = jax_tc_cli.main(common + ["--save_path", str(voc["root"] / "jt")])
    got = tc_cli.main(common + ["--save_path", str(voc["root"] / "pt"),
                                "--device", "cpu"])
    assert list(got) == list(want) and "TCSum_layer2_head1" in got
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-4, atol=1e-5)
    saved = json.loads((voc["root"] / "pt" / "Token_Contrast" /
                        "sum_token_contrast.json").read_text())
    assert saved == got


def test_clip_scorer_waits_for_a7b(voc, tmp_path):
    args = _search_args(voc, "clip", "Wsupervised")
    args[args.index("itc")] = "clip"
    with pytest.raises(SystemExit, match="A7b"):
        search_cli.main(args + ["--device", "cpu"])

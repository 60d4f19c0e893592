"""The port's GPT-4o labeler against the JAX package's, on one fake VOC
directory with one stub transport.

Both ``label_dataset``s see the same images, prompts and answers: a
success, a success after two timeouts, a ``BadRequest``, three timeouts
(tries exhausted), a result that is not a string, and a second success.
Their output JSON, ``no_output_idx.json`` and ``no_return.json`` must be
byte-equal after a first run over four images and after a second run
that resumes and asks only for the rest. ``main`` runs through a stub
OpenAI SDK module: no network.
"""

import base64
import json
import sys
import types

import numpy as np
import pytest
from PIL import Image

from pnp_ovss_tpu.cli import labeler as jax_labeler
from pnp_ovss_tpu_torch.cli import labeler

N_IMG = 6
FILES = ("voc_classification_noboundary.json", "no_output_idx.json",
         "no_return.json")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_labeler")
    base = root / "VOCdevkit/VOC2012"
    (base / "ImageSets/Segmentation").mkdir(parents=True)
    (base / "JPEGImages").mkdir()
    (base / "SegmentationClass").mkdir()
    rng = np.random.RandomState(0)
    ids = [f"2007_{i:06d}" for i in range(N_IMG)]
    b64 = {}
    for img_id in ids:
        path = base / "JPEGImages" / f"{img_id}.jpg"
        Image.fromarray((rng.rand(20, 24, 3) * 255).astype(np.uint8)) \
            .save(path)
        Image.fromarray(np.zeros((20, 24), np.uint8)).save(
            base / "SegmentationClass" / f"{img_id}.png")
        b64[base64.b64encode(path.read_bytes()).decode("ascii")] = img_id
    (base / "ImageSets/Segmentation/val.txt").write_text("\n".join(ids)
                                                         + "\n")
    return dict(root=str(root), ids=ids, b64=b64)


def _stub(voc, bad_request):
    """A transport whose answer depends on the image (by its position in
    the split) and on how often that image was asked before."""
    asked, prompts = {}, []

    def request(image_b64, prompt):
        i = voc["ids"].index(voc["b64"][image_b64])
        n = asked[i] = asked.get(i, 0) + 1
        prompts.append(prompt)
        if i == 1 and n <= 2 or i == 3:
            raise TimeoutError("slow gateway")
        if i == 2:
            raise bad_request()
        if i == 4:
            return None
        return f"[{i + 1}: 'class{i}'], [{90 + i}%]"

    return request, asked, prompts


def _run(mod, voc, out, limit):
    request, asked, prompts = _stub(voc, mod.BadRequest)
    sleeps = []
    produced = mod.label_dataset("voc", voc["root"], str(out), request,
                                 limit=limit, sleep_fn=sleeps.append)
    return produced, asked, prompts, sleeps


def test_labeler_files_are_byte_equal_to_jax(voc, tmp_path):
    outs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    mods = {"port": labeler, "jax": jax_labeler}
    assert labeler.PROMPT_TEMPLATE == jax_labeler.PROMPT_TEMPLATE
    for limit, want_asked in ((4, {0: 1, 1: 3, 2: 1, 3: 3}),
                              (None, {4: 1, 5: 1})):
        runs = {k: _run(mods[k], voc, outs[k], limit) for k in outs}
        produced, asked, prompts, sleeps = runs["port"]
        assert asked == want_asked  # a resumed run skips the done ids
        assert runs["jax"][1:] == runs["port"][1:]
        assert produced == runs["jax"][0]
        assert len(sleeps) == (5 if limit else 0)
        assert sleeps == [20.0] * len(sleeps)
        for name in FILES:
            port_file, jax_file = outs["port"] / name, outs["jax"] / name
            assert port_file.exists() == jax_file.exists(), name
            if jax_file.exists():
                assert port_file.read_bytes() == jax_file.read_bytes(), name
    ids = voc["ids"]
    done = json.loads((outs["port"] / FILES[0]).read_text())
    assert list(done) == ids
    assert done[ids[0]] == "[1: 'class0'], [90%]"
    assert done[ids[1]] == "[2: 'class1'], [91%]"
    assert done[ids[2]] == done[ids[3]] == done[ids[4]] == ""
    assert (outs["port"] / FILES[1]).read_text() == \
        f'["{ids[2]}", "{ids[3]}"]'
    assert (outs["port"] / FILES[2]).read_text() == f'["{ids[4]}"]'


def test_main_through_a_stub_openai_sdk(voc, tmp_path, monkeypatch):
    """``main`` builds the SDK transport (imported only there) with the
    key and model given, and the request carries the prompt and the
    image as a PNG data URL."""
    made, sent = [], []

    class Completions:
        def create(self, **kw):
            sent.append(kw)
            msg = types.SimpleNamespace(content="[12: 'dog'], [88%]")
            return types.SimpleNamespace(
                choices=[types.SimpleNamespace(message=msg)])

    class OpenAI:
        def __init__(self, api_key):
            made.append(api_key)
            self.chat = types.SimpleNamespace(completions=Completions())

    monkeypatch.setitem(sys.modules, "openai",
                        types.SimpleNamespace(OpenAI=OpenAI))
    out = tmp_path / "gpt"
    got = labeler.main(["--apikey", "sk-test", "--data_type", "voc",
                        "--home_dir", voc["root"], "--output_dir", str(out),
                        "--model", "gpt-4o-mini", "--limit", "2"])
    assert made == ["sk-test"]
    assert got == {i: "[12: 'dog'], [88%]" for i in voc["ids"][:2]}
    assert [kw["model"] for kw in sent] == ["gpt-4o-mini"] * 2
    content = sent[0]["messages"][0]["content"]
    assert content[0]["text"].startswith("Help me find")
    url = content[1]["image_url"]["url"]
    assert url.startswith("data:image/png;base64,")
    assert voc["b64"][url.split(",", 1)[1]] == voc["ids"][0]
    assert sent[0]["temperature"] == 0.0
    assert (out / FILES[0]).exists()

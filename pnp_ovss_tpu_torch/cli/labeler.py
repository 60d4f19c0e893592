"""Offline GPT-4o class-proposal labeler (the port's copy of
``pnp_ovss_tpu/cli/labeler.py``; reference gpt_rewrite_label.py):

    python -m pnp_ovss_tpu_torch.cli.labeler --apikey KEY --data_type voc \\
        --home_dir DATA --output_dir DATA/GPT4o_classification

It writes the ``GPT4o_classification/{data_type}_classification_noboundary
.json`` cache that the segmentation CLI reads (``text/labels.py``), with
the reference's fault tolerance (its only fault-tolerant component):

- resume: an existing output JSON is loaded and its ids skipped
  (gpt_rewrite_label.py:199-214);
- 3 tries with a 20 s sleep after a timeout or other error (:288-291);
- ``BadRequest``: an empty string, and the id appended to
  ``no_output_idx.json`` (:272-287); so are ids whose tries all failed;
- a result that is not a string: an empty string, and the id appended to
  ``no_return.json`` (:276-316);
- the output JSON merge-written after every image (:319-334).

The transport is a ``request_fn(image_b64, prompt) -> str``, so the
labeler runs offline in tests and against any endpoint. The OpenAI SDK is
imported only inside ``make_openai_request_fn``, which ``main`` calls.
The labeler is host-only: it touches no tensor and no card.
"""

from __future__ import annotations

import base64
import json
import os
import time
from typing import Callable, Dict, List, Optional

from pnp_ovss_tpu_torch.data.categories import get_dataset_meta
from pnp_ovss_tpu_torch.data.datasets import make_dataset

PROMPT_TEMPLATE = (
    "Help me find as much and accurate as possible, categories appearing in "
    "the image among the available categories {cats}. Double check if there "
    "is anything missing. You may output unsure categories and give them "
    "lower probability, but at most 25 categories. Output strictly in the "
    "format [id1: classname1, id2: classname2, ...], [probability of class1 "
    "in percentage, probability of class2 in percentage, ...] without other "
    "words. You have to output at least one category."
)


def _append_error(path: str, img_id: str) -> None:
    ids: List[str] = []
    if os.path.exists(path):
        with open(path) as f:
            ids = json.load(f)
    ids.append(img_id)
    with open(path, "w") as f:
        json.dump(ids, f)


def _merge_write(path: str, updates: Dict[str, str]) -> None:
    data: Dict[str, str] = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.update(updates)
    with open(path, "w") as f:
        json.dump(data, f)


def make_openai_request_fn(api_key: str, model: str = "gpt-4o") -> Callable:
    import openai

    client = openai.OpenAI(api_key=api_key)

    def request(image_b64: str, prompt: str) -> str:
        response = client.chat.completions.create(
            model=model,
            messages=[{
                "role": "user",
                "content": [
                    {"type": "text", "text": prompt},
                    {"type": "image_url", "image_url": {
                        "url": f"data:image/png;base64,{image_b64}"}},
                ],
            }],
            temperature=0.0,
        )
        return response.choices[0].message.content

    return request


class BadRequest(Exception):
    """Raise from request_fn for non-retryable failures."""


def label_dataset(
    data_type: str,
    home_dir: str,
    output_dir: str,
    request_fn: Callable[[str, str], str],
    *,
    max_retries: int = 3,
    retry_sleep_s: float = 20.0,
    limit: Optional[int] = None,
    sleep_fn=time.sleep,
) -> Dict[str, str]:
    meta = get_dataset_meta(data_type)
    cats_for_prompt = {
        i + 1: name for i, name in enumerate(meta.nms)
    }
    prompt = PROMPT_TEMPLATE.format(cats=cats_for_prompt)

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(
        output_dir, f"{data_type}_classification_noboundary.json"
    )

    done: Dict[str, str] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            done = json.load(f)

    ds = make_dataset(data_type, home_dir)
    records = list(ds.records())
    if limit:
        records = records[:limit]

    produced: Dict[str, str] = {}
    for rec in records:
        if rec.gpt_key in done:
            continue
        with open(rec.image_path, "rb") as f:
            image_b64 = base64.b64encode(f.read()).decode("ascii")

        _PENDING = object()  # distinguishes "never succeeded" from None
        result = _PENDING
        for attempt in range(max_retries):
            try:
                result = request_fn(image_b64, prompt)
                break
            except BadRequest:
                result = ""
                _append_error(
                    os.path.join(output_dir, "no_output_idx.json"),
                    rec.gpt_key,
                )
                break
            except Exception:
                sleep_fn(retry_sleep_s)
        if result is _PENDING:  # exhausted retries
            result = ""
            _append_error(
                os.path.join(output_dir, "no_output_idx.json"), rec.gpt_key
            )
        elif not isinstance(result, str):
            # The request "succeeded" but returned no usable content — the
            # reference logs these to a second failure file
            # (gpt_rewrite_label.py:276-316 no_return.json).
            result = ""
            _append_error(
                os.path.join(output_dir, "no_return.json"), rec.gpt_key
            )
        _merge_write(out_path, {rec.gpt_key: result})
        produced[rec.gpt_key] = result
    return produced


def main(argv=None):
    """Label a dataset through the OpenAI SDK; returns the labels written
    this run, {gpt_key: raw answer}."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--apikey", required=True)
    p.add_argument("--data_type", required=True)
    p.add_argument("--home_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model", default="gpt-4o")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)

    return label_dataset(
        args.data_type, args.home_dir, args.output_dir,
        make_openai_request_fn(args.apikey, args.model), limit=args.limit,
    )


if __name__ == "__main__":
    main()

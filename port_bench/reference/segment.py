"""The segmentation pipeline around the model, as plain equations
(reference script ``pnp_ovss.py``; LAVIS BLIP-ITM):

- captions: "A picture of " + the class names, [ENC] first, [SEP] last,
  padded to one length for the whole pool (the smallest multiple of 64
  that holds every caption); the pooling matrix averages each class's
  rows of the GradCAM (row r is text position r + 1);
- the salience drop: per round, zero the pixels of every patch dropped
  so far, encode, take GradCAM, zero it at dropped patches, sum it over
  the class rows [3:-1], and drop the 10 best patches not dropped yet;
  the aggregate adds every round's map and round 0's once more;
- finishing: pool the rows into class maps, keep a map where its
  min-max-normalised value reaches the threshold (the raw value kept),
  resize bilinearly (align_corners) to the bucket, min-max the round-0
  variant to [0, 1];
- postprocess: a background channel (1 where every class map is 0), a
  Gaussian blur as scipy's ``gaussian_filter`` (truncate 4, "reflect")
  with sigma 0.05 * the bucket side, min-max per channel, disabled
  channels at -1e30, and a mean-field DenseCRF: unary -log(clip(softmax,
  1e-5, 1)); a spatial Gaussian and a bilateral Gaussian over (x/sx,
  y/sy, rgb/srgb), each normalised symmetrically by its degree; 10
  iterations of ``Q <- softmax(-U + bi_w m_bi + pos_w m_sp)``. With a
  subsample s > 1 the bilateral sum runs over every s-th pixel on each
  axis; s = 1 is the exact CRF.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .blip_itm import BlipItm
from .precision import EXACT, Rounding

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
PREFIX = ("a", "picture", "of")
DISABLED = -1e30
UNARY_CLIP = 1e-5
MINMAX_FLAT = 1e-2
# Two salience sums within this share of the largest are a tie.
CHOICE_TIE = 1e-5
# Labels are the best of the last state: a pixel whose two best
# probabilities lie within rounding may go either way, and a mean gap
# above this is no rounding.
LABEL_GAP = 0.01


# -- captions -------------------------------------------------------------
def caption_length(class_lists: Sequence[Sequence[str]],
                   max_text_len: int) -> int:
    """The pool's padded text length."""
    need = max(len(PREFIX) + 2 + sum(len(n.split()) for n in names)
               for names in class_lists)
    return min(max_text_len, max(64, -(-need // 64) * 64))


def caption(names: Sequence[str], vocab: Dict[str, int], length: int,
            max_classes: int):
    """-> (ids [T], mask [T], pool [K, T-1]) of one image."""
    ids = [vocab["[ENC]"]] + [vocab[w] for w in PREFIX]
    pool = np.zeros((max_classes, length - 1), np.float32)
    for k, name in enumerate(names):
        words = name.lower().split()
        row = len(ids) - 1
        pool[k, row:row + len(words)] = 1.0 / len(words)
        ids += [vocab[w] for w in words]
    ids.append(vocab["[SEP]"])
    mask = np.zeros((length,), np.int64)
    mask[:len(ids)] = 1
    ids = np.asarray(ids + [vocab["[PAD]"]] * (length - len(ids)), np.int64)
    return ids, mask, pool


def normalise(image_u8: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> CLIP-normalised float32."""
    mean = torch.tensor(CLIP_MEAN, device=image_u8.device)
    std = torch.tensor(CLIP_STD, device=image_u8.device)
    return (image_u8.float() / 255.0 - mean) / std


# -- the salience drop ------------------------------------------------------
def drop_round(model: BlipItm, image: torch.Tensor, ids, mask,
               dropped: torch.Tensor, *, layer: int, head: int,
               patch: int):
    """One round for one image from the drop mask ``dropped`` [P] it
    starts from -> (gradcam [T-1, g, g], salience [P] with dropped
    patches at -inf, the image embeddings [S, D])."""
    g = model.grid
    keep = (1.0 - dropped).reshape(g, g)
    pixels = keep.repeat_interleave(patch, 0).repeat_interleave(patch, 1)
    emb = model.encode((image * pixels[..., None])[None])
    gc, _ = model.gradcam(emb, ids[None], mask[None], layer=layer,
                          head=head)
    gc = gc[0] * keep[None]
    return gc, salience(gc, dropped), emb[0]


def salience(gc: torch.Tensor, dropped: torch.Tensor) -> torch.Tensor:
    """The class rows' sum [P]; dropped patches at -inf."""
    sal = gc[3:-1].sum(0).reshape(-1)
    return sal.masked_fill(dropped > 0, float("-inf"))


def best_patches(salience: torch.Tensor, k: int) -> torch.Tensor:
    """The k best patches; ties go to the lower index."""
    return torch.sort(salience, descending=True, stable=True).indices[:k]


# -- finishing ----------------------------------------------------------------
def _upsample(maps: torch.Tensor, size: int, rounding: Rounding):
    """[K, g, g] -> [K, size, size], bilinear with align_corners."""
    g = maps.shape[-1]
    src = torch.arange(size, dtype=torch.float64, device=maps.device) \
        * ((g - 1) / (size - 1))
    lo = torch.clamp(src.floor().long(), 0, g - 2)
    w = (src - lo).to(maps.dtype)
    a = torch.zeros((size, g), dtype=maps.dtype, device=maps.device)
    idx = torch.arange(size, device=maps.device)
    a[idx, lo] = 1.0 - w
    a[idx, lo + 1] += w
    a = rounding.round("finishing", a)
    y = rounding.round("finishing", a @ rounding.round("finishing", maps))
    return y @ a.t()


def _minmax01(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(x.shape[0], -1)
    mn, mx = flat.amin(1), flat.amax(1)
    d = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    return (x - mn[:, None, None]) / d[:, None, None]


def finish(gradcam: torch.Tensor, pool: torch.Tensor, *, threshold: float,
           size: int, rescale: bool, rounding: Rounding = EXACT,
           decide: Optional[torch.Tensor] = None,
           band: float = 0.0) -> torch.Tensor:
    """gradcam [T-1, g, g] -> class maps [K, size, size].

    ``band`` > 0 leaves a threshold decision whose normalised value lies
    within ``band`` of the threshold to ``decide`` (maps at ``size`` that
    the decision is judged against): each such element takes whichever
    side brings the result nearer to ``decide``. The comparison uses it
    so that a rounding at the threshold is not read as a fault."""
    g = gradcam.shape[-1]
    pooled = (rounding.round("finishing", pool)
              @ rounding.round("finishing", gradcam.reshape(
                  gradcam.shape[0], -1))).reshape(-1, g, g)
    flat = pooled.reshape(pooled.shape[0], -1)
    mn, mx = flat.amin(1)[:, None, None], flat.amax(1)[:, None, None]
    denom = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    normed = torch.where(mx > mn, (pooled - mn) / denom,
                         torch.zeros_like(pooled))
    on = normed >= threshold

    def result(on_mask):
        up = _upsample(pooled * on_mask, size, rounding)
        return _minmax01(up) if rescale else up

    out = result(on)
    if band > 0 and decide is not None:
        near = torch.nonzero((normed - threshold).abs() < band)
        for k, y, x in near[:16].tolist():
            flip = on.clone()
            flip[k, y, x] = ~flip[k, y, x]
            alt = result(flip)
            if (alt - decide).norm() < (out - decide).norm():
                on, out = flip, alt
    return out


# -- postprocess --------------------------------------------------------------
def blur_matrix(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """[n, n] 1D Gaussian filter with scipy's "reflect" boundary
    (d c b a | a b c d | d c b a)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    a = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(-radius, radius + 1):
            j = (i + t) % (2 * n)
            if j >= n:
                j = 2 * n - 1 - j
            a[i, j] += k[t + radius]
    return a


def background_enabled(data_type: str, n_classes: int) -> bool:
    """Object datasets (voc, coco_object) always keep a background
    channel; context datasets only below three classes."""
    return data_type in ("voc", "coco_object") or n_classes < 3


def crf_logits(maps_r0: torch.Tensor, maps_agg: torch.Tensor,
               class_valid: torch.Tensor, bg_enable: bool, *,
               blur_scale: float, rounding: Rounding = EXACT,
               with_spread: bool = False):
    """Two variants' class maps [K, H, W] -> the CRF's logits [2, K+1,
    H, W]: background, blur, min-max, disabled channels. ``with_spread``
    also returns each blurred channel's range over its magnitude [2,
    K+1], before the min-max."""
    maps = torch.stack([maps_r0, maps_agg]).float()
    maps = torch.where(class_valid[None, :, None, None], maps,
                       torch.zeros_like(maps))
    bg = (maps.amax(1, keepdim=True) == 0).float()
    wbg = torch.cat([bg, maps], 1)
    h, w = wbg.shape[-2:]
    sigma = blur_scale * max(h, w)
    bh = torch.as_tensor(blur_matrix(h, sigma), dtype=torch.float32,
                         device=maps.device)
    bw = torch.as_tensor(blur_matrix(w, sigma), dtype=torch.float32,
                         device=maps.device)
    r = lambda x: rounding.round("blur", x)  # noqa: E731
    y = r(r(bh) @ r(wbg)) @ r(bw).t()
    flat = y.reshape(2, -1, h * w)
    mn, mx = flat.amin(-1), flat.amax(-1)
    d = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    y = (y - mn[..., None, None]) / d[..., None, None]
    valid = torch.cat([torch.tensor([bool(bg_enable)], device=maps.device),
                       class_valid.bool()])
    out = torch.where(valid[None, :, None, None], y,
                      torch.full_like(y, DISABLED))
    if not with_spread:
        return out
    spread = (mx - mn) / torch.clamp(torch.maximum(mx.abs(), mn.abs()),
                                     min=1e-30)
    return out, spread


def bilateral_features(rgb: torch.Tensor, sxy, srgb: float) -> torch.Tensor:
    """[H, W, 3] -> [H*W, 5]: (x / sxy[0], y / sxy[1], rgb / srgb)."""
    h, w, _ = rgb.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=rgb.device),
        torch.arange(w, dtype=torch.float32, device=rgb.device),
        indexing="ij")
    f = torch.stack([xs / sxy[0], ys / sxy[1]], -1)
    return torch.cat([f, rgb.float() / srgb], -1).reshape(h * w, 5)


def gaussian_kernel(fi: torch.Tensor, fj: torch.Tensor,
                    rows: int = 1024) -> torch.Tensor:
    """exp(-||f_i - f_j||^2 / 2) -> [N, M], explicit differences."""
    out = torch.empty((fi.shape[0], fj.shape[0]), dtype=torch.float32,
                      device=fi.device)
    for lo in range(0, fi.shape[0], rows):
        d = fi[lo:lo + rows, None, :] - fj[None]
        out[lo:lo + rows] = torch.exp(-0.5 * (d * d).sum(-1))
    return out


class MeanField:
    """The mean-field CRF of one image: logits [V, C, H, W], rgb [H, W, 3]
    0-255; ``xy_scale`` (sx, sy) multiplies the spatial stds per axis.
    ``q0`` is the first state [V*C, N]; ``step(q)`` one iteration."""

    def __init__(self, logits: torch.Tensor, rgb: torch.Tensor, crf: Dict,
                 *, subsample: int, xy_scale, rounding: Rounding = EXACT):
        v, c, h, w = logits.shape
        n, s = h * w, subsample
        dev = logits.device
        sx, sy = float(xy_scale[0]), float(xy_scale[1])
        self.shape, self.crf, self.rounding = (v, c, h, w), crf, rounding
        self.q0 = torch.softmax(logits.float(), dim=1).reshape(v * c, n)
        self.u = -torch.log(torch.clamp(self.q0, UNARY_CLIP, 1.0))
        feats = bilateral_features(rgb, (crf["bi_xy_std"] * sx,
                                         crf["bi_xy_std"] * sy),
                                   crf["bi_rgb_std"])
        self.support = torch.arange(n, device=dev).reshape(h, w)[::s, ::s] \
            .reshape(-1)
        self.kern = rounding.kernel(gaussian_kernel(feats,
                                                    feats[self.support]))
        self.norm_bi = torch.rsqrt(torch.clamp(self.kern.sum(1), min=1e-20))

        def band(m, sigma):
            i = torch.arange(m, dtype=torch.float32, device=dev)
            return torch.exp(-0.5 * ((i[:, None] - i[None]) / sigma) ** 2)

        self.kh = band(h, crf["pos_xy_std"] * sy)
        self.kw = band(w, crf["pos_xy_std"] * sx)
        self.norm_sp = torch.rsqrt(torch.clamp(
            (self.kh.sum(1)[:, None] * self.kw.sum(1)[None]).reshape(n),
            min=1e-20))

    def step(self, q: torch.Tensor) -> torch.Tensor:
        v, c, h, w = self.shape
        n = h * w
        crf = self.crf
        r = lambda x: self.rounding.round("crf_state", x)  # noqa: E731
        q = q.float()
        qj = r(q[:, self.support] * self.norm_bi[self.support])
        m_bi = self.norm_bi * (qj @ self.kern.t())
        qs = r(q * self.norm_sp).reshape(v * c, h, w)
        m_sp = self.norm_sp * (self.kh @ qs @ self.kw.t()).reshape(v * c, n)
        e = -self.u + crf["bi_w"] * m_bi + crf["pos_w"] * m_sp
        return torch.softmax(e.reshape(v, c, n), dim=1).reshape(v * c, n)

    def run(self) -> List[torch.Tensor]:
        """Every state after an iteration."""
        q, out = self.q0, []
        for _ in range(self.crf["num_iters"]):
            q = self.step(q)
            out.append(q)
        return out


def mean_field(logits: torch.Tensor, rgb: torch.Tensor, crf: Dict, *,
               subsample: int, xy_scale, rounding: Rounding = EXACT
               ) -> torch.Tensor:
    """The last state, as [V, C, H*W]."""
    v, c, h, w = logits.shape
    mf = MeanField(logits, rgb, crf, subsample=subsample, xy_scale=xy_scale,
                   rounding=rounding)
    return mf.run()[-1].reshape(v, c, h * w)


# -- one image through the whole pipeline (the control) -----------------------
def aggregate(gcs: List[torch.Tensor], double_count: bool) -> torch.Tensor:
    agg = sum(gcs[1:], gcs[0])
    return agg + gcs[0] if double_count else agg


def run_image(model: BlipItm, image_u8: torch.Tensor, ids, mask, pool,
              class_valid, bg_enable: bool, rgb: torch.Tensor, xy_scale,
              pipe: Dict, rounding: Rounding) -> Dict[str, torch.Tensor]:
    """The reference in the program's place: every stage of one image in
    ``rounding``'s formats, its own drop choices. Returns the record the
    comparison reads, as the program's."""
    drop = pipe["drop"]
    att = pipe["attribution"]
    post = pipe["postprocess"]
    g = model.grid
    img = normalise(image_u8)
    dropped = torch.zeros(g * g, device=img.device)
    gcs, ins, outs, embs = [], [], [], []
    for _ in range(drop["num_rounds"]):
        gc, sal, emb = drop_round(model, img, ids, mask, dropped,
                                  layer=att["layer"], head=att["head"],
                                  patch=model.vcfg["patch_size"])
        embs.append(emb)
        ins.append(dropped)
        new = torch.zeros_like(dropped)
        new[best_patches(sal, drop["patches_per_round"])] = 1.0
        dropped = torch.clamp(dropped + new, 0, 1)
        outs.append(dropped)
        gcs.append(gc)
    gc0, agg = gcs[0], aggregate(gcs, drop["double_count_round0"])
    size = pipe["bucket"]
    maps_r0 = finish(gc0, pool, threshold=pipe["threshold"], size=size,
                     rescale=True, rounding=rounding)
    maps_agg = finish(agg, pool, threshold=pipe["threshold"], size=size,
                      rescale=False, rounding=rounding)
    logits = crf_logits(maps_r0, maps_agg, class_valid, bg_enable,
                        blur_scale=post["blur_scale"], rounding=rounding)
    states = MeanField(logits, rgb, post["crf"],
                       subsample=post["bilateral_subsample"],
                       xy_scale=xy_scale, rounding=rounding).run()
    labels = states[-1].reshape(2, -1, size * size).argmax(1) \
        .reshape(2, size, size)
    return {"encode": torch.stack(embs),
            "gradcam": torch.stack(gcs), "dropped_in": torch.stack(ins),
            "dropped_out": torch.stack(outs), "maps_r0": maps_r0,
            "maps_agg": maps_agg, "labels": labels, "crf_logits": logits,
            "crf_states": torch.stack(states),
            "crf_first": torch.tensor(1)}


# -- the comparison -------------------------------------------------------------
def _norm(x: torch.Tensor) -> float:
    return float(x.double().norm())


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    nb = _norm(b)
    d = _norm(a.double() - b.double())
    return d / nb if nb > 0 else d


def judge_image(model: BlipItm, model_stated: BlipItm,
                rec: Dict[str, torch.Tensor], image_u8, ids, mask, pool,
                class_valid, bg_enable: bool, rgb, xy_scale, pipe: Dict, *,
                crf_stated: Rounding, threshold_band: float) -> Dict:
    """The readings of one image, which ``combine`` turns into the numbers
    compared. ``model_stated`` and ``crf_stated`` are the reference at
    the configuration's stated precisions of the model and the CRF, whose
    gaps are the units of the record's GradCAM and CRF states. The reference follows the record's own state stage by
    stage: each drop round from the record's drop mask, the finishing
    from the record's GradCAMs, the blur from the record's class maps,
    the CRF's first state from the record's CRF input, and each CRF
    iteration from the record's state before it (``crf_states``: the states after iterations
    ``crf_first``.., or from the first state when ``crf_first`` is 0)."""
    drop, att, post = pipe["drop"], pipe["attribution"], pipe["postprocess"]
    g, k = model.grid, drop["patches_per_round"]
    img = normalise(image_u8)
    rounds = []
    for r in range(drop["num_rounds"]):
        d_in = rec["dropped_in"][r].float()
        d_out = rec["dropped_out"][r].float()
        want_in = torch.zeros(g * g, device=img.device) if r == 0 \
            else rec["dropped_out"][r - 1].float()
        gc, _, emb = drop_round(model, img, ids, mask, d_in,
                                layer=att["layer"], head=att["head"],
                                patch=model.vcfg["patch_size"])
        got = rec["gradcam"][r].float()
        gc_st, _, _ = drop_round(model_stated, img, ids, mask, d_in,
                                 layer=att["layer"], head=att["head"],
                                 patch=model.vcfg["patch_size"])
        new = d_out - d_in
        # The record's drop state follows the rules, and its choice is the
        # best of its own GradCAM (ties to within rounding either way).
        sal = salience(got.double(), d_in)
        chosen = sal[new > 0]
        kth = torch.sort(sal, descending=True).values[k - 1] \
            if int((d_in == 0).sum()) >= k else -float("inf")
        tol = CHOICE_TIE * float(sal[torch.isfinite(sal)].abs().max()) \
            if bool(torch.isfinite(sal).any()) else 0.0
        sound = (torch.equal(d_in, want_in)
                 and bool(((d_out == 0) | (d_out == 1)).all())
                 and bool(((new == 0) | (new == 1)).all())
                 and int(new.sum()) == min(k, int((d_in == 0).sum()))
                 and bool((chosen >= kth - tol).all()))
        rounds.append({"round": r, "ref_norm": _norm(gc),
                       "diff_norm": _norm(got - gc),
                       "stated_diff_norm": _norm(gc_st - gc),
                       "encode_rel_err": _rel(rec["encode"][r].float(), emb),
                       "sound": sound})
    gcs = [rec["gradcam"][r].float() for r in range(drop["num_rounds"])]
    agg = aggregate(gcs, drop["double_count_round0"])
    size = pipe["bucket"]
    maps_err = 0.0
    for gc_v, key, rescale in ((gcs[0], "maps_r0", True),
                               (agg, "maps_agg", False)):
        got = rec[key].float()
        ref = finish(gc_v.double(), pool.double(), threshold=pipe["threshold"],
                     size=size, rescale=rescale, decide=got.double(),
                     band=threshold_band).float()
        maps_err = max(maps_err, _rel(got, ref))

    logits, spread = crf_logits(
        rec["maps_r0"].float(), rec["maps_agg"].float(), class_valid,
        bg_enable, blur_scale=post["blur_scale"], with_spread=True)
    got = rec["crf_logits"].float()
    on = logits[:, :, 0, 0] > DISABLED / 2  # the enabled channels [2, C]
    # A channel whose blur is constant to within MINMAX_FLAT of its size
    # carries no shape: the min-max maps its rounding onto [0, 1], so only
    # the range is held.
    shaped = on & (spread >= MINMAX_FLAT)
    blur_err = _rel(got[shaped], logits[shaped])
    flat_ok = bool(((got[on & ~shaped] >= 0) & (got[on & ~shaped] <= 1))
                   .all())
    if not flat_ok or not bool((got[~on] <= DISABLED / 2).all()):
        blur_err = float("inf")  # out of range, or a disabled channel on
    mf = MeanField(got, rgb, post["crf"],
                   subsample=post["bilateral_subsample"], xy_scale=xy_scale)
    mf_st = MeanField(got, rgb, post["crf"],
                      subsample=post["bilateral_subsample"],
                      xy_scale=xy_scale, rounding=crf_stated)
    rows = mf.q0.shape[0]
    states = [s[:rows].float() for s in rec["crf_states"]]
    first = int(rec["crf_first"])
    iters = post["crf"]["num_iters"]
    if len(states) != iters or first not in (0, 1):
        raise ValueError(f"{len(states)} CRF states recorded from "
                         f"iteration {first}; want {iters}")
    # Pairs (state before, state after) of the record; the first state
    # is the reference's own where the record starts after iteration 1.
    chain = ([mf.q0] + states) if first == 1 else states
    step_sq = 0.0 if first == 1 else _norm(states[0] - mf.q0) ** 2
    stated_sq = 0.0
    for before, after in zip(chain[:-1], chain[1:]):
        want = mf.step(before)
        step_sq += _norm(after - want) ** 2
        stated_sq += _norm(mf_st.step(before) - want) ** 2
    last = mf.step(chain[-2] if first == 1 else chain[-1])
    q = last.reshape(2, -1, size * size)
    lab = rec["labels"].reshape(2, 1, -1).long()
    gap = q.amax(1) - q.gather(1, lab)[:, 0]
    return {"rounds": rounds, "maps_rel_err": maps_err,
            "blur_rel_err": blur_err, "crf_step_sq": step_sq,
            "crf_stated_sq": stated_sq,
            "crf_label_gap": float(gap.mean(1).amax())}


def combine(images: List[Dict]) -> Dict[str, float]:
    """The numbers compared, over the sampled images:

    - ``encode_rel_err``: the widest relative L2 gap of a round's image
      embeddings (the ViT encode of the record's masked image);
    - ``gradcam_err_ratio``: the GradCAMs' L2 gap from the reference,
      over every round of the sample, in units of the gap that the
      reference itself makes at the configuration's stated precision of
      the model on the same rounds. GradCAM passes a gradient through a
      relu, and with random weights many gradients lie near zero (the
      image embeddings are nearly alike), so how far rounding moves a
      GradCAM differs by orders of magnitude from image to image; the
      stated precision's own gap is that scale. A round whose drop state
      does not follow the rules, or whose choice is not the best of its
      own GradCAM, reads 1e30;
    - ``maps_rel_err``: the widest relative L2 gap of an image's class
      maps against the reference's finishing of its own GradCAMs;
    - ``blur_rel_err``: the widest relative L2 gap of the CRF's input
      (background, blur, min-max) over the enabled channels with a shape
      against the reference's from the record's class maps (1e30 where a
      disabled channel is not at -1e30 or a flat one leaves [0, 1]);
    - ``crf_err_ratio``: the CRF states' L2 gap from the reference's
      iteration from the record's state before each, over every iteration
      and image, in units of the gap that the reference at the stated
      precisions of the CRF makes in the same iterations; 1e30 where the
      labels are not the best of the reference's last iteration to within
      ``LABEL_GAP`` of mean probability."""
    rounds = [r for im in images for r in im["rounds"]]
    num = float(np.sqrt(sum(r["diff_norm"] ** 2 for r in rounds)))
    den = float(np.sqrt(sum(r["stated_diff_norm"] ** 2 for r in rounds)))
    gc = num / den if den > 0 else (0.0 if num == 0 else 1e30)
    if not all(r["sound"] for r in rounds):
        gc = 1e30
    num = float(np.sqrt(sum(im["crf_step_sq"] for im in images)))
    den = float(np.sqrt(sum(im["crf_stated_sq"] for im in images)))
    step = num / den if den > 0 else (0.0 if num == 0 else 1e30)
    if any(im["crf_label_gap"] > LABEL_GAP for im in images):
        step = 1e30
    return {"encode_rel_err": max(r["encode_rel_err"] for r in rounds),
            "gradcam_err_ratio": gc,
            "maps_rel_err": max(im["maps_rel_err"] for im in images),
            "blur_rel_err": max(im["blur_rel_err"] for im in images),
            "crf_err_ratio": step}


def xy_scale_of(gt_size, bucket: int):
    """(sx, sy) = (bucket / gt_w, bucket / gt_h)."""
    h, w = gt_size
    return (bucket / w, bucket / h)

"""COCO mask codec: compressed RLE encode/decode, area, IoU, polygon
rasterization, and the eval-time mask paste.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
rle.py``, with ``paste_mask_box_local`` of ``cvpr22_cross_modal_pseudo_
labeling_tpu/ops/masks.py`` (a module that imports jax) copied in.

pycocotools is not available in this environment; the reference relies
on it throughout (structures/segmentation_mask.py, evaluation/coco).
This module re-implements the public COCO mask format from its spec:
column-major (Fortran) run-length counts, alternating 0-runs/1-runs
starting with zeros, compressed to ASCII with 6-bit LEB128-style chunks
(char = 48 + chunk, bit 0x20 = continuation) and delta coding of counts
from index 2 on.  A C++ drop-in of the hot paths lives in
``native/maskops.cpp`` (used when built; this numpy path is the
fallback and the golden reference for its tests).
"""

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

RLE = Dict[str, Union[str, List[int], Sequence[int]]]


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary [H, W] mask -> run counts (column-major, starts with the
    zero-run)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [n]])
    counts = np.diff(bounds)
    if flat[0] == 1:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    # one vectorized pass: runs alternate 0/1 starting at 0
    counts = np.asarray(counts, np.int64)
    vals = (np.arange(counts.size, dtype=np.int64) & 1).astype(np.uint8)
    flat = np.repeat(vals, counts)
    total = h * w
    if flat.size < total:  # tolerate short run lists (trailing zeros)
        flat = np.concatenate([flat, np.zeros(total - flat.size, np.uint8)])
    return flat[:total].reshape((h, w), order="F")


def compress_counts(counts: Sequence[int]) -> str:
    """LEB128-style 6-bit compression with delta coding (COCO spec).

    Vectorized: 5-bit groups emitted in at most 13 numpy passes over
    the whole counts array instead of a per-character python loop (the
    eval hot path encodes ~100 RLEs per image)."""
    arr = np.asarray(counts, np.int64)
    n = arr.size
    if n == 0:
        return ""
    x = arr.copy()
    # delta coding from index 3 onward — maskApi.c rleToString uses
    # `if(i>2) x-=cnts[i-2]`, i.e. the first THREE counts are raw (a
    # commonly mis-ported quirk; starting at index 2 breaks
    # interoperability with every pycocotools-compressed string whose
    # leading zero-run is nonzero)
    x[3:] = arr[3:] - arr[1:-2]
    max_groups = 13  # ceil(64 / 5) covers any int64 delta
    chunks = np.zeros((max_groups, n), np.uint8)
    emitted = np.zeros((max_groups, n), bool)
    more = np.ones(n, bool)
    for g in range(max_groups):
        if not more.any():
            break
        c = (x & 0x1F).astype(np.int64)
        x = x >> 5
        done = ((x == 0) & ((c & 0x10) == 0)) | (
            (x == -1) & ((c & 0x10) != 0)
        )
        cont = more & ~done
        chunks[g] = (c | np.where(cont, 0x20, 0)).astype(np.uint8)
        emitted[g] = more
        more = cont
    # per value, its groups in order: row-major boolean pick on [n, G]
    data = chunks.T[emitted.T] + 48
    return data.astype(np.uint8).tobytes().decode("ascii")


def decompress_counts(s: Union[str, bytes]) -> List[int]:
    """Vectorized inverse of compress_counts (the segm-eval hot path
    decodes ~100 RLEs per image, each for area AND IoU): chunk groups
    found from the continuation bit, per-group 5-bit recombination via
    segmented shifts, then the maskApi.c `if(m>2)` delta undone as two
    interleaved cumulative sums (even/odd index chains)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    if not s:
        return []
    c = np.frombuffer(s, np.uint8).astype(np.int64) - 48
    more = (c & 0x20) != 0
    if more[-1]:
        # the final chunk still has the continuation bit set: the string
        # was cut mid-value.  Fail loudly like the scalar decoder's
        # past-the-end read did, instead of returning a wrong count.
        raise ValueError("truncated RLE counts string")
    # group id per chunk: a new value starts after each chunk with the
    # continuation bit clear
    starts = np.concatenate([[True], ~more[:-1]])
    gid = np.cumsum(starts) - 1
    n = int(gid[-1]) + 1
    # position of each chunk within its group -> shift amount
    start_idx = np.flatnonzero(starts)
    pos = np.arange(len(c)) - start_idx[gid]
    vals = np.zeros(n, np.int64)
    np.add.at(vals, gid, (c & 0x1F) << (5 * pos))
    # sign extension: the LAST chunk of a group with bit 0x10 set
    last = ~more
    neg = last & ((c & 0x10) != 0)
    np.add.at(vals, gid[neg], (-1 << (5 * (pos[neg] + 1))))
    # undo the index>2 delta: counts[i] = vals[i] + counts[i-2] for
    # i >= 3 — two cumsum chains (odd indices from counts[1], even
    # from counts[2])
    if n > 3:
        vals[3::2] = np.cumsum(np.concatenate([[vals[1]], vals[3::2]]))[1:]
        vals[4::2] = np.cumsum(np.concatenate([[vals[2]], vals[4::2]]))[1:]
    return vals.tolist()


def encode_mask(mask: np.ndarray) -> RLE:
    h, w = mask.shape
    return {
        "size": [int(h), int(w)],
        "counts": compress_counts(mask_to_counts(mask)),
    }


def encode_box_mask(
    crop: np.ndarray, x0: int, y0: int, image_hw
) -> RLE:
    """RLE of a full-image mask that is zero outside the box whose
    clipped crop is ``crop`` placed at (x0, y0) — WITHOUT materializing
    the H x W canvas.  O(box area) instead of O(image area): at COCO
    eval scale (100 dets x 800x1333) the canvas paste+encode costs
    ~2.5 s/image, this path ~10 ms.

    Column-major runs never merge across image columns here because a
    clipped crop narrower than the image leaves zero gaps between
    columns; the h == H full-height case is handled by merging."""
    H, W = int(image_hw[0]), int(image_hw[1])
    h, w = crop.shape
    if h == 0 or w == 0 or not crop.any():
        return {"size": [H, W], "counts": compress_counts([H * W])}
    # per-column run starts/ends from a zero-padded vertical diff
    zpad = np.zeros((h + 2, w), np.int8)
    zpad[1:-1] = crop
    d = np.diff(zpad, axis=0)  # +1 at run start row, -1 past run end
    # column-major ordering: transpose so nonzero() yields (col, row)
    cs, rs = np.nonzero((d == 1).T)
    ce, re = np.nonzero((d == -1).T)
    # starts/ends pair up within each column in order
    starts = (np.int64(x0) + cs) * H + (y0 + rs)
    lengths = (re - rs).astype(np.int64)
    # merge runs that touch across columns (only possible when the crop
    # spans full image height and adjacent-column runs abut)
    abuts = starts[1:] == starts[:-1] + lengths[:-1]
    if abuts.any():
        keep = np.concatenate([[True], ~abuts])
        group = np.cumsum(keep) - 1
        merged_len = np.zeros(int(group[-1]) + 1, np.int64)
        np.add.at(merged_len, group, lengths)
        starts = starts[keep]
        lengths = merged_len
    counts = np.empty(2 * len(starts) + 1, np.int64)
    counts[0] = starts[0]
    counts[1::2] = lengths
    counts[2::2][:-1] = starts[1:] - (starts[:-1] + lengths[:-1])
    counts[-1] = H * W - (starts[-1] + lengths[-1])
    if counts[-1] == 0:
        counts = counts[:-1]
    return {"size": [H, W], "counts": compress_counts(counts)}


def paste_mask_box_local(
    mask_probs: np.ndarray,
    box: np.ndarray,
    image_hw: Tuple[int, int],
    threshold: float = 0.5,
    padding: int = 1,
):
    """One mask's Masker math (mask_head/inference.py:96-218) WITHOUT
    the full-image canvas: pad the M x M probs by 1, expand the box by
    the matching scale, bilinear-resize (align_corners=False) to the
    (+1 convention) box size, threshold, clip to the image.  The copy of
    ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/masks.py::
    paste_mask_box_local``.

    Returns (binarized [h, w] uint8, x0, y0) — the image-frame placement
    of the clipped crop — or None when the box is fully outside."""
    im_h, im_w = image_hw
    m = mask_probs.shape[-1]
    scale = float(m + 2 * padding) / m
    mask = np.zeros((m + 2 * padding, m + 2 * padding), np.float32)
    # explicit end index: `[padding:-padding]` is the EMPTY slice when
    # padding == 0 (a valid Masker setting), silently zeroing every mask
    mask[padding:padding + m, padding:padding + m] = mask_probs

    box = np.asarray(box, np.float32)
    w_half = (box[2] - box[0]) * 0.5 * scale
    h_half = (box[3] - box[1]) * 0.5 * scale
    x_c = (box[2] + box[0]) * 0.5
    y_c = (box[3] + box[1]) * 0.5
    ebox = np.array(
        [x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half]
    ).astype(np.int32)

    w = max(int(ebox[2] - ebox[0] + 1), 1)
    h = max(int(ebox[3] - ebox[1] + 1), 1)

    try:
        # cv2 INTER_LINEAR uses the same align_corners=False half-pixel
        # mapping as F.interpolate; SIMD beats the numpy path ~10x
        import cv2

        resized = cv2.resize(mask, (w, h), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        ys = (np.arange(h) + 0.5) * mask.shape[0] / h - 0.5
        xs = (np.arange(w) + 0.5) * mask.shape[1] / w - 0.5
        y0 = np.floor(ys).astype(np.int32)
        x0 = np.floor(xs).astype(np.int32)
        ly = (ys - y0).astype(np.float32)
        lx = (xs - x0).astype(np.float32)
        y0c, y1c = np.clip(y0, 0, mask.shape[0] - 1), np.clip(
            y0 + 1, 0, mask.shape[0] - 1
        )
        x0c, x1c = np.clip(x0, 0, mask.shape[1] - 1), np.clip(
            x0 + 1, 0, mask.shape[1] - 1
        )
        # separable two-pass: rows [h, M+2] then columns [h, w]
        rows = mask[y0c] * (1 - ly)[:, None] + mask[y1c] * ly[:, None]
        resized = rows[:, x0c] * (1 - lx) + rows[:, x1c] * lx
    binarized = (resized > threshold).astype(np.uint8)

    x_0 = max(int(ebox[0]), 0)
    x_1 = min(int(ebox[2]) + 1, im_w)
    y_0 = max(int(ebox[1]), 0)
    y_1 = min(int(ebox[3]) + 1, im_h)
    if x_1 <= x_0 or y_1 <= y_0:
        return None
    crop = binarized[
        (y_0 - ebox[1]) : (y_1 - ebox[1]), (x_0 - ebox[0]) : (x_1 - ebox[0])
    ]
    return crop, x_0, y_0


def encode_pasted_mask(
    mask_probs: np.ndarray,
    box: np.ndarray,
    image_hw,
    threshold: float = 0.5,
    padding: int = 1,
) -> RLE:
    """Masker paste + COCO RLE encode fused in box-local space (the
    eval hot path, reference coco_eval.py:108-146)."""
    res = paste_mask_box_local(
        np.asarray(mask_probs, np.float32),
        box,
        (int(image_hw[0]), int(image_hw[1])),
        threshold,
        padding,
    )
    H, W = int(image_hw[0]), int(image_hw[1])
    if res is None:
        return {"size": [H, W], "counts": compress_counts([H * W])}
    crop, x0, y0 = res
    return encode_box_mask(crop, x0, y0, (H, W))


def decode_rle(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decompress_counts(counts)
    return counts_to_mask(counts, h, w)


def rle_area(rle: RLE) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decompress_counts(counts)
    return int(sum(counts[1::2]))


def _rle_to_runs(rle: RLE) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decompress_counts(counts)
    return np.asarray(counts, np.int64)


def rle_iou(dt: RLE, gt: RLE, is_crowd: bool = False) -> float:
    """IoU between two RLEs; crowd gt -> intersection over dt area."""
    a = decode_rle(dt).astype(bool)
    b = decode_rle(gt).astype(bool)
    inter = np.logical_and(a, b).sum()
    if is_crowd:
        denom = a.sum()
    else:
        denom = a.sum() + b.sum() - inter
    return float(inter) / max(float(denom), 1e-10)


def rle_iou_matrix(
    dts: Sequence[RLE], gts: Sequence[RLE], iscrowd: Sequence[bool]
) -> np.ndarray:
    """[len(dts), len(gts)] IoU matrix.

    Dispatches to the native run-merge kernel (native/maskops.cpp,
    O(runs) per pair like pycocotools' C core) and falls back to the
    decode-based numpy path (O(H*W) per pair)."""
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)), np.float64)
    from .native import native_rle_iou_matrix

    native = native_rle_iou_matrix(dts, gts, iscrowd)
    if native is not None:
        return native
    d_masks = [decode_rle(d).astype(bool) for d in dts]
    g_masks = [decode_rle(g).astype(bool) for g in gts]
    d_areas = [m.sum() for m in d_masks]
    g_areas = [m.sum() for m in g_masks]
    out = np.zeros((len(dts), len(gts)), np.float64)
    for j, (gm, ga, crowd) in enumerate(zip(g_masks, g_areas, iscrowd)):
        for i, (dm, da) in enumerate(zip(d_masks, d_areas)):
            inter = np.logical_and(dm, gm).sum()
            denom = da if crowd else da + ga - inter
            out[i, j] = inter / max(float(denom), 1e-10)
    return out


def merge_rles(rles: Sequence[RLE]) -> RLE:
    """Union of instance masks (used for crowd/polygon multi-part)."""
    mask = decode_rle(rles[0]).astype(bool)
    for r in rles[1:]:
        mask |= decode_rle(r).astype(bool)
    return encode_mask(mask.astype(np.uint8))


def polygons_to_mask(
    polygons: Sequence[Sequence[float]], h: int, w: int
) -> np.ndarray:
    """Rasterizes COCO polygon lists ([x0,y0,x1,y1,...] per part) to a
    binary [H, W] mask (frPyObjects+merge equivalent)."""
    import cv2

    mask = np.zeros((h, w), np.uint8)
    pts = [
        np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def coco_segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Dispatch: polygons | uncompressed RLE | compressed RLE."""
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, list):
            return counts_to_mask(counts, *seg["size"])
        return decode_rle(seg)
    raise TypeError(f"Unknown segmentation type {type(seg)}")

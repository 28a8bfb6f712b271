"""The host-side plans of the bf16 kernels on the TMA and wgmma, in plain
Python: K5's bf16 weight sums (``csrc/reduce_bf16.cu``), K8, K7 and K6 in
bf16 (``csrc/conv_bf16.cu``), K4 in bf16 (``csrc/level_bf16.cu``) and K5's
bf16 row pass (``csrc/level_bwd_bf16.cu``); of K5's d_plane pass in every
dtype (``csrc/level_bwd.cu``); of K9 (``csrc/tile_gather.cu``), of the
run scatter (``csrc/pool2.cu`` ``scatter_runs``), of K2 alone
(``pool_gather``) and of the run kernel (``pool_runs``). The C launchers
compute the same plans (the functions and configs there of the same names);
the wrappers size their scratch and splits from these, and check K5's two,
K9's, the run scatter's, K2's and the run kernel's against the C side's at
their first launch at each shape, and ``tests/test_torch_tile_plan.py``,
``tests/test_torch_scatter_runs.py`` and ``tests/test_torch_pool2_runs.py``
emulate them in numpy: every output element covered once, the sums equal to
the plain versions'.

K9: a warp owns 32 rows, a (row, 16-byte chunk) item a lane, one or two a
lane at once (their corner loads in flight); a row takes ``lpr`` lanes
(:func:`tile_gather_plan`).

The weight sums ``dw = A^T B``, ``db = colsum(B)`` over M rows: a block owns
a ``bk`` x ``bn`` tile of dw and one split of the rows, streamed in stages of
:data:`REDUCE_ROWS` rows; the ``ny`` tiles along Ka each sum the bias over
the stages ``s % ny == y`` of their split, so the scratch holds ``Ka + ny``
rows a split with a bias.

K8: a block owns :data:`CONV_PIXELS` output pixels, a ``th`` x ``tw``
rectangle of one image, by ``bn`` output channels; its K steps run over the
nine taps, then the ``ck``-channel chunks, each loading the input box
(``ck``, ``tw``, ``th``) whose origin is the rectangle's moved by the tap
(:func:`tap_origin`), zero outside the image and past Cin. K7 runs its two
convs on the same plan; its second conv, where it pools, takes rectangles of
whole 2x2 windows (even width, height and origins) and pools them in its
epilogue.

K6 runs its three convs on K8's plan: conv1 and conv2 as K8 (each by its
own route), conv3 with the decoder head in its epilogue on the plan of
Cin = C2, Cout = C3 (bn 64: one block column owns all of x3's channels), w4's
columns ``oc`` a pass (:func:`decoder_plan`); two threads a pixel, each on
every other 16-byte chunk of each part (:data:`HEAD_THREADS`).

K4: a block owns ``bm`` rows of one batch entry (128, two warpgroups of 64;
64 at F = 512, where the warpgroups split o's columns), in hidden chunks of
``hc`` columns: ``n_in`` stages of ``ki`` W_in rows, then ``n_out`` of ``ko``
W_out rows, a chunk; then ``n_c`` stages of ``ko`` c_last columns with W_c's
rows, in the order of :func:`level_tiles`. Every width runs the one route
(F and Fl padded to multiples of 8).

K5's bf16 row pass (``csrc/level_bwd_bf16.cu``): F <= 256, a block owns
``bm`` = 128 rows in two warpgroups of 64, with two rings of 8 KB TMA boxes:
ring A holds the W_in columns of one hidden chunk (``slots`` boxes of
:data:`LEVEL_BWD_SLICE` rows of F), read once by the pre-activation and once,
transposed, by d_s, then loaded again with the next chunk's; ring B streams
W_c^T's stages for d_c_last (``n_dc`` column chunks of ``nc``, ``n_kc``
stages of ``kc`` rows each), then per hidden chunk its ``n_out`` W_out^T
slices. F = 512 (``split``): 64 rows, in two phases, each warpgroup with a
ring of its own: the pre-activations of its hidden chunks, then its half
of d_c_last's columns, then per pair of chunks d_h of its chunk and its
half of d_s's columns. The order of each ring is :func:`level_bwd_tiles`'s.
Every width runs the one route (F and Fl padded to multiples of 8).

K5's d_plane pass (``csrc/level_bwd.cu`` ``d_plane_tiles``): a block owns a
``tx`` x ``ty`` tile of pixels of one batch entry and ``fc`` features
(``tpp`` threads a pixel, ``groups`` 16-byte lanes a thread; more pixels
at fine levels, fewer at coarse ones). It walks the
finest cells under the union of its pixels' rectangles
(:func:`d_plane_tile_rect`) in row-major order, ``cells`` at a time, and
their rows in row order, ``cap`` at a time, their d_s lines ``lines`` rows
at a time in shared memory; each pixel adds the rows of its own rectangle
in that order, which is the order in which a walk of the pixel's own
rectangle meets them.
"""

from __future__ import annotations

REDUCE_ROWS = 64
"""Rows a stage of the weight sums (``kRows``)."""

CONV_PIXELS = 128
"""Output pixels a block of K8 in bf16 (``kPix``)."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reduce_tile(ka: int, nb: int) -> tuple[int, int]:
    """(bk, bn): the weight sums' output tile along Ka (64, or 128: two
    consumer warpgroups) and along Nb (64, 128 or 256)."""
    return (64 if ka <= 64 else 128), (64 if nb <= 64 else 128 if nb <= 128 else 256)


def reduce_grid(ka: int, nb: int) -> tuple[int, int]:
    """(nx, ny): the tiles along Nb and along Ka."""
    bk, bn = reduce_tile(ka, nb)
    return cdiv(nb, bn), cdiv(ka, bk)


def reduce_splits(m: int, ka: int, nb: int, sms: int) -> int:
    """Row splits: about one block an SM over the tiles, at least four stages
    a split, and no split past the rows."""
    nx, ny = reduce_grid(ka, nb)
    first = max(1, min(sms // (nx * ny), cdiv(m, 4 * REDUCE_ROWS)))
    return cdiv(m, reduce_rows_per_split(m, first))


def reduce_rows_per_split(m: int, splits: int) -> int:
    """Rows of a split: ceil(m / splits) up to whole stages; the last split
    ends at m (later ones, if any, are empty and write zeros)."""
    return cdiv(cdiv(m, splits), REDUCE_ROWS) * REDUCE_ROWS


def reduce_part_rows(ka: int, nb: int, bias: bool) -> int:
    """Rows of a split's f32 partial sums: Ka, and the ny bias rows."""
    return ka + (reduce_grid(ka, nb)[1] if bias else 0)


LEVEL_WIDTHS = (64, 128, 256, 512)
"""K4 bf16's width classes (``level_fp``): F rounded up to one of them."""


def level_plan(f: int, fl: int) -> dict:
    """K4 bf16's block plan at widths (F, Fl) (``LevelWgmmaCfg``): the width
    class fp; ``cols`` (F = 512: the warpgroups split o's columns); rows a
    block bm; hidden chunk hc; o's and a chunk's columns a warpgroup (on,
    hn); W_in rows a stage ki; W_out / W_c rows and c_last columns a stage
    ko; the ring's stages; and the stage counts n_h (chunks), n_in and n_out
    (a chunk), n_c (c_last)."""
    if not 0 < f <= 512:
        raise ValueError(f"K4 bf16 takes 0 < F <= 512, got {f}")
    fp = next(w for w in LEVEL_WIDTHS if f <= w)
    cols = fp == 512
    hc = 128 if cols else 64
    ki = 64 if fp == 64 else 128
    ko = 64 if fp <= 128 else 32
    return {"fp": fp, "cols": cols, "bm": 64 if cols else 128, "hc": hc,
            "on": fp // 2 if cols else fp, "hn": 64, "ki": ki, "ko": ko,
            "stages": {64: 3, 128: 4, 256: 5, 512: 3}[fp],
            "n_h": cdiv(2 * f, hc), "n_in": cdiv(f, ki), "n_out": hc // ko,
            "n_c": cdiv(fl, ko)}


def level_tiles(plan: dict) -> list[tuple[str, int, int]]:
    """K4 bf16's tile sequence, in the order thread 0 loads the ring and the
    products take it: ("in", c, v) the v-th W_in tile of hidden chunk c,
    ("out", c, v) its v-th W_out tile, ("c", 0, v) the v-th c_last box with
    W_c's rows: chunk by chunk, its W_in tiles then its W_out tiles, the
    c_last tiles last."""
    tiles = [(kind, c, v) for c in range(plan["n_h"])
             for kind, n in (("in", plan["n_in"]), ("out", plan["n_out"])) for v in range(n)]
    return tiles + [("c", 0, v) for v in range(plan["n_c"])]


def conv_route(cin: int, cout: int, aligned: bool = True) -> str:
    """"wgmma" (``conv3x3_wgmma``: the TMA wants 16-byte row pitches and
    addresses) or "flat" (the conv core's flat-K path: Cin = 3)."""
    return "wgmma" if cin % 8 == 0 and cout % 8 == 0 and aligned else "flat"


def conv_plan(b: int, h: int, w: int, cin: int, cout: int, sms: int,
              pool: bool = False) -> dict:
    """K8 bf16's blocks (and K7's convs): the rectangle (tw, th), its counts
    along x and y, the rectangles (b * tiles_y * tiles_x), the channel chunk
    ck and the output tile bn (256 where Cout > 128 and that still gives
    ``sms`` blocks), and the blocks (rectangles x channel tiles). With
    ``pool`` (K7's pooled second conv; W even) the rectangles hold whole 2x2
    windows: tw = min(W, 64), th = 128 / tw rounded down to even."""
    tw = min(w, CONV_PIXELS // 2 if pool else CONV_PIXELS)
    th = CONV_PIXELS // tw
    if pool:
        th -= th % 2
    tiles_x, tiles_y = cdiv(w, tw), cdiv(h, th)
    rects = b * tiles_y * tiles_x
    ck = 32 if cin <= 32 else 64
    if cout <= 64:
        bn = 64
    elif cout <= 128 or rects * cdiv(cout, 256) < sms:
        bn = 128
    else:
        bn = 256
    return {"tw": tw, "th": th, "tiles_x": tiles_x, "tiles_y": tiles_y, "rects": rects,
            "ck": ck, "bn": bn, "blocks": rects * cdiv(cout, bn)}


def conv_block(plan: dict, cout: int, block: int) -> tuple[int, int, int, int]:
    """(image, x0, y0, n0) of block ``block``: a rectangle's channel tiles
    are neighbours, rectangles run x fastest, then y, then image."""
    ntn = cdiv(cout, plan["bn"])
    rect, nt = divmod(block, ntn)
    tx = rect % plan["tiles_x"]
    ty = (rect // plan["tiles_x"]) % plan["tiles_y"]
    return rect // (plan["tiles_x"] * plan["tiles_y"]), tx * plan["tw"], ty * plan["th"], \
        nt * plan["bn"]


def tap_origin(x0: int, y0: int, tap: int) -> tuple[int, int]:
    """The (x, y) origin of tap ``tap``'s input box (HWIO tap order: dy =
    tap // 3 - 1, dx = tap % 3 - 1) for the rectangle at (x0, y0)."""
    return x0 + tap % 3 - 1, y0 + tap // 3 - 1


HEAD_W4_BYTES = 8192
"""Shared memory for w4's f32 columns a pass of K6's head (``kHeadW4Bytes``)."""

HEAD_THREADS = 2
"""Threads a pixel in K6's head (the 256 consumer threads over 128 pixels)."""


def head_columns(ct: int, co: int) -> int:
    """w4's columns a pass of K6's head (``head_columns``): as many as fit
    HEAD_W4_BYTES of f32 rows of ``ct`` = C0 + C1 + C2 + C3, at least one,
    at most CO."""
    return max(1, min(HEAD_W4_BYTES // (4 * ct), co))


def head_route(c0: int, c1: int, c2: int, c3: int, aligned: bool = True) -> str:
    """"wgmma" (conv3 and the head on ``conv3x3_wgmma``: every width a
    multiple of 8, x3 within one 64-channel block column) or "flat" (the
    conv core's ``conv3x3_head_igemm``)."""
    ok = all(c % 8 == 0 for c in (c0, c1, c2, c3)) and c3 <= 64 and aligned
    return "wgmma" if ok else "flat"


def decoder_plan(b: int, h: int, w: int, c0: int, c1: int, c2: int, c3: int, co: int,
                 sms: int, aligned=(True, True, True)) -> dict:
    """K6 in bf16: the route of each conv (conv1, conv2, conv3 with the
    head; ``aligned`` says for each whether the tensors it reads and writes
    are 16-byte aligned: x, w1, x1; x1, w2, x2; x, x1, x2, w3), conv1's and
    conv2's plans (:func:`conv_plan`, None on the flat route), and conv3's
    with the head's columns ``oc`` a pass (None on the flat route). C3 must
    be at most 64."""
    if c3 > 64:
        raise ValueError(f"K6 takes C3 <= 64, got {c3}")
    routes = (conv_route(c0, c1, aligned[0]), conv_route(c1, c2, aligned[1]),
              head_route(c0, c1, c2, c3, aligned[2]))
    plans = [conv_plan(b, h, w, ci, c, sms) if r == "wgmma" else None
             for r, (ci, c) in zip(routes, ((c0, c1), (c1, c2), (c2, c3)))]
    if plans[2] is not None:
        plans[2] = {**plans[2], "oc": head_columns(c0 + c1 + c2 + c3, co)}
    return {"routes": routes, "conv1": plans[0], "conv2": plans[1], "head": plans[2]}


LEVEL_BWD_SLICE = 64
"""Rows of F a W_in or W_out^T box holds, and hidden columns a chunk, in K5's
bf16 row pass (``kSlice``)."""

LEVEL_BWD_STAGE = 8192
"""Bytes of a ring slot of K5's bf16 row pass (``kStageBytes``)."""


def level_bwd_plan(f: int, fl: int) -> dict:
    """K5's bf16 row pass at widths (F, Fl) (``LevelBwdCfg`` and
    ``LevelBwdSplitCfg``, mirrored by ``t2h_level_bwd_plan_bf16``): the width
    class fp; ``split`` (F = 512: ``fused_level_bwd_wgmma_split``, the
    warpgroups splitting the hidden chunks and d_s's columns, each with a
    ring of its own); rows a block bm; hidden columns a chunk hc; F rows a
    W_in / W_out^T box ki; ring A's slots (a chunk of W_in; none in the
    split) and ring B's stages (the split: each warpgroup's ring's);
    d_c_last's columns a chunk nc (the split: half a warpgroup) and W_c^T
    rows a stage kc; d_s's columns a warpgroup ns; the counts n_h (chunks),
    n_in (W_in boxes, W_out^T slices a chunk), n_dc (d_c_last column
    chunks), n_kc (W_c^T stages a column chunk); and the dynamic shared
    memory in bytes."""
    if not 0 < f <= 512:
        raise ValueError(f"K5's bf16 row pass takes 0 < F <= 512, got {f}")
    fp = next(w for w in LEVEL_WIDTHS if f <= w)
    sl, st = LEVEL_BWD_SLICE, LEVEL_BWD_STAGE
    if fp == 512:
        bm, nc, kc, ns, slots, stages = 64, 256, st // 256, 256, 0, 8
        smem = 1024 + bm * fp * 2 + 2 * bm * sl * 2 + 2 * stages * st
    else:
        bm, nc, ns, slots = 128, fp, fp, fp // sl
        kc, stages = st // (2 * nc), {64: 4, 128: 8, 256: 5}[fp]
        smem = 1024 + 2 * bm * fp * 2 + bm * sl * 2 + (slots + stages) * st
    return {"fp": fp, "split": fp == 512, "bm": bm, "hc": sl, "ki": sl, "slots": slots,
            "stages": stages, "nc": nc, "kc": kc, "ns": ns, "n_h": cdiv(2 * f, sl),
            "n_in": cdiv(f, sl), "n_dc": cdiv(fl, nc), "n_kc": cdiv(f, kc), "smem": smem}


LEVEL_BWD_PLAN_KEYS = ("fp", "split", "bm", "hc", "ki", "slots", "stages", "nc", "kc", "ns",
                       "n_h", "n_in", "n_dc", "n_kc", "smem")
"""The order in which ``t2h_level_bwd_plan_bf16`` writes the plan's integers."""


def level_bwd_tiles(plan: dict) -> dict:
    """K5 bf16's tile sequences, each in the order its consumers take it.
    F <= 256: ring "a", ("in", c, v), W_in's box v of hidden chunk c; ring
    "b", ("c", j, v), W_c^T's stage v of d_c_last's column chunk j, all of
    them first, then ("out", c, v), W_out^T's slice v of chunk c. F = 512:
    ring "wg0" and "wg1", warpgroup w's: ("in", c, v) for its chunks c = w,
    w + 2, .. (phase A); its ("c", j, v) stages (its half of chunk j's
    columns); then per pair of chunks (2p, 2p + 1) its chunk's ("out", 2p +
    w, v) slices, if it has one, and ("ds", c, v), the W_in boxes v of its
    d_s rows (4w .. 4w + 3) for each chunk c of the pair."""
    n_h, n_in = plan["n_h"], plan["n_in"]
    cols = [("c", j, v) for j in range(plan["n_dc"]) for v in range(plan["n_kc"])]
    if not plan["split"]:
        return {"a": [("in", c, v) for c in range(n_h) for v in range(n_in)],
                "b": cols + [("out", c, v) for c in range(n_h) for v in range(n_in)]}
    rings = {}
    for w in (0, 1):
        half = range(4 * w, min(4 * w + 4, n_in))
        seq = [("in", c, v) for c in range(w, n_h, 2) for v in range(n_in)] + list(cols)
        for p in range(cdiv(n_h, 2)):
            if 2 * p + w < n_h:
                seq += [("out", 2 * p + w, v) for v in range(n_in)]
            seq += [("ds", c, v) for c in range(2 * p, min(2 * p + 2, n_h)) for v in half]
        rings[f"wg{w}"] = seq
    return rings


DPLANE_THREADS = 256
"""Threads a block of K5's d_plane pass."""

DPLANE_STEP = 512
"""Finest cells a step of the d_plane pass's walk (two a thread), and rows
an entry batch (two a thread)."""

DPLANE_LINES = 24576
"""Bytes of d_s lines in each of the two line buffers of a block of the
d_plane pass (the next batch's lines load while this one's are walked)."""

DPLANE_SUMS = 32
"""The most f32 sums a thread of the d_plane pass keeps (groups x vec)."""


def d_plane_plan(r: int, f: int, fr: int, elem: int) -> dict:
    """K5's d_plane pass at resolution R, width F, finest resolution fr and
    d_s elements of ``elem`` bytes (``t2h_level_d_plane_plan``): vec features
    a 16-byte lane; tpp threads a pixel and ``groups`` lanes a thread (lane k
    * tpp + g for thread g of its pixel, at most :data:`DPLANE_SUMS` sums a
    thread), so fc = tpp x groups x vec features a block; the pixel tile tx
    x ty (256 / tpp pixels) with its counts along x and y; the feature
    chunks; the block's threads; the walk's cells a step and rows an entry
    batch (``cells``, ``cap``: two a thread); and ``lines``, the rows of a
    line batch (:data:`DPLANE_LINES` bytes of lines a buffer). Sized
    by level: more pixels at fine levels, fewer at coarse ones. Where a
    pixel spans one finest cell (R = fr) a thread takes as many lanes as it
    can (up to 256 pixels a block); where it spans rho = fr / R cells along
    each axis, tpp is at least 2 rho (up to 16: 16 pixels a block)."""
    if r < 1 or fr < r:
        raise ValueError(f"d_plane pass takes 1 <= R <= fr, got R={r}, fr={fr}")
    vec = 16 // elem
    lanes = cdiv(f, vec)
    gmax = DPLANE_SUMS // vec
    rho = max(1, fr // r)
    level = 1 if rho <= 1 else min(16, 2 * rho)
    tpp = min(lanes, 16, max(level, cdiv(lanes, gmax)))
    groups = min(gmax, cdiv(lanes, tpp))
    fc = tpp * groups * vec
    pixels = DPLANE_THREADS // tpp
    tx = 16 if pixels >= 128 else 8 if pixels >= 32 else 4
    ty = pixels // tx
    return {"vec": vec, "fc": fc, "tpp": tpp, "groups": groups, "tx": tx, "ty": ty,
            "tiles_x": cdiv(r, tx), "tiles_y": cdiv(r, ty), "chunks": cdiv(f, fc),
            "threads": DPLANE_THREADS, "cells": DPLANE_STEP, "cap": DPLANE_STEP,
            "lines": min(DPLANE_STEP, DPLANE_LINES // (fc * elem))}


D_PLANE_PLAN_KEYS = ("vec", "fc", "tpp", "groups", "tx", "ty", "tiles_x", "tiles_y", "chunks",
                     "threads", "cells", "cap", "lines")
"""The order in which ``t2h_level_d_plane_plan`` writes the plan's integers."""


def cell_span(p: int, r: int, fr: int, margin: int = 1) -> tuple[int, int]:
    """The finest cells [lo, hi] along one axis whose rows can touch pixel p
    of R (``csrc/level_bwd.cu`` ``cell_span``): x0 in {p - 1, p} puts the
    row's cell in [(p - 1) fr // (R - 1), (p + 1) fr // (R - 1)], widened by
    ``margin`` cells each side and clipped; every cell where R < 2."""
    if r < 2:
        return 0, fr - 1
    lo = (p - 1) * fr // (r - 1) - margin if p >= 1 else 0
    hi = (p + 1) * fr // (r - 1) + margin
    return max(lo, 0), min(hi, fr - 1)


def d_plane_tile_rect(plan: dict, r: int, fr: int, tile_x: int, tile_y: int):
    """The pixels (x0, x1, y0, y1, inclusive) of tile (tile_x, tile_y) and
    the finest cells (cx0, cx1, cy0, cy1) under the union of their
    rectangles: the first pixel's lower bound to the last's upper one."""
    x0, y0 = tile_x * plan["tx"], tile_y * plan["ty"]
    x1, y1 = min(x0 + plan["tx"], r) - 1, min(y0 + plan["ty"], r) - 1
    return (x0, x1, y0, y1), (cell_span(x0, r, fr)[0], cell_span(x1, r, fr)[1],
                              cell_span(y0, r, fr)[0], cell_span(y1, r, fr)[1])


GATHER_WARPS = 8
"""Warps a block of K9 (``kGatherWarps``)."""

GATHER_ROWS = 32
"""Rows a warp of K9 (``kGatherRows``): one a lane for the corners."""

GATHER_LANES = 32
"""Lanes a row of K9 at most past 32 chunks a row (``kGatherLanes``)."""


def tile_gather_plan(f: int, elem: int, aligned: bool = True) -> dict:
    """K9's row -> lane map at width F for elements of ``elem`` bytes
    (``gather_plan`` in ``csrc/tile_gather.cu``, mirrored by
    ``t2h_tile_gather_plan``): vec features a lane's 16-byte chunk (one where
    F is no multiple of 16 / elem or the plane or output is not 16-byte
    aligned); cpr chunks a row; lpr lanes a row (cpr up to 32, past it the
    largest power of two up to :data:`GATHER_LANES` dividing cpr); items a
    lane at once (one at vec = 8, bf16's 16 bytes, else two: 32 corner
    values a lane in flight); rows a warp (:data:`GATHER_ROWS`), taken in
    steps of 32 x items items; rows a block. Lane l's items in step s are
    e = 32 (items s + u) + l for u < items: row (e // lpr) % 32, chunk
    (e // (32 lpr)) lpr + e % lpr, features chunk * vec onwards (rows past
    the entry's last skipped)."""
    if f < 1:
        raise ValueError(f"K9 takes F >= 1, got {f}")
    vec = 16 // elem if aligned and f % (16 // elem) == 0 else 1
    cpr = f // vec
    lpr = cpr
    if cpr > 32:
        lpr = GATHER_LANES
        while cpr % lpr:
            lpr //= 2
    items = 1 if vec == 8 else 2
    return {"vec": vec, "cpr": cpr, "lpr": lpr, "items": items, "rows": GATHER_ROWS,
            "steps": cdiv(GATHER_ROWS * cpr, 32 * items),
            "block_rows": GATHER_ROWS * GATHER_WARPS}


TILE_GATHER_PLAN_KEYS = ("vec", "cpr", "lpr", "items", "rows", "steps", "block_rows")
"""The order in which ``t2h_tile_gather_plan`` writes the plan's integers."""


SPAN = 32
"""Rows a warp of the run scatter owns (``kSpan`` in ``csrc/pool2.cu``)."""


def scatter_runs_plan(f: int, elem: int, aligned: bool = True) -> dict:
    """The run scatter's plan at width F for values of ``elem`` bytes
    (``runs_plan`` in ``csrc/pool2.cu``, mirrored by
    ``t2h_scatter_runs_plan``): vec features a lane of the run part (bf16: 8,
    16 bytes, from F = 256 on; 4 from F = 128 on, 2 from 64, else 1; 1 for
    values not 16-byte aligned); chunks of 32 vec features a span (a warp
    each); group, the rows a lane loads at once (32 registers of values, at
    most a span: bf16 keeps two values a register from vec = 2 on); item,
    the values a zero item stores (16 bytes where F is a multiple of 16 /
    elem, else 1); q items a cell and qshift = log2(q), or -1 where q is no
    power of two."""
    if aligned and elem == 2 and f % 8 == 0 and f >= 256:
        vec = 8
    elif aligned and f % 4 == 0 and f >= 128:
        vec = 4
    elif aligned and f % 2 == 0 and f >= 64:
        vec = 2
    else:
        vec = 1
    regs = vec // 2 if elem == 2 and vec > 1 else vec  # registers a row's values take
    group = min(SPAN, 32 // regs)
    item = 16 // elem if f % (16 // elem) == 0 else 1
    q = f // item
    return {"vec": vec, "chunks": cdiv(f, 32 * vec), "group": group, "item": item, "q": q,
            "qshift": q.bit_length() - 1 if q > 0 and q & (q - 1) == 0 else -1}


SCATTER_RUNS_PLAN_KEYS = ("vec", "chunks", "group", "item", "q", "qshift")
"""The order in which ``t2h_scatter_runs_plan`` writes the plan's integers."""


GATHER_BATCH = 4
"""Rows of a segment whose loads go out at once in K2's items route
(``kGatherBatch`` in ``csrc/pool2.cu``)."""

GATHER_GROUP = 16
"""Rows whose loads go out at once in K2's lane-a-feature route
(``kGatherGroup``)."""


def pool_gather_plan(f: int, elem: int, aligned: bool = True) -> dict:
    """K2 alone's plan (``csrc/pool2.cu`` ``pool_gather_plan``, mirrored by
    ``t2h_pool_gather_plan``) at width F for values of ``elem`` bytes, the
    plane and the output 16-byte aligned or not: ``items`` 1 takes
    ``pool_gather_items`` (F a multiple of 16 / elem, aligned), 0
    ``pool_gather`` (a lane a feature, a warp a span and 32 features); vec
    values an item (16 bytes; 1 on ``pool_gather``); cpr chunks a row; lpr
    lanes a row (min(cpr, 32)); segs segments a span, of seg_rows
    consecutive rows each (32 / lpr, and 32 / segs rounded up), lane l
    taking chunk l % lpr of segment l // lpr's rows in row order; chunks,
    the chunk groups a warp walks (``pool_gather``: the warps a span, one
    each 32 features); batch, the rows whose loads go out at once."""
    if f < 1:
        raise ValueError(f"K2 takes F >= 1, got {f}")
    items = aligned and f % (16 // elem) == 0
    vec = 16 // elem if items else 1
    cpr = f // vec
    lpr = min(cpr, 32) if items else 32
    segs = 32 // lpr if items else 1
    return {"items": int(items), "vec": vec, "cpr": cpr, "lpr": lpr, "segs": segs,
            "seg_rows": cdiv(SPAN, segs), "chunks": cdiv(cpr, lpr),
            "batch": GATHER_BATCH if items else GATHER_GROUP}


POOL_GATHER_PLAN_KEYS = ("items", "vec", "cpr", "lpr", "segs", "seg_rows", "chunks", "batch")
"""The order in which ``t2h_pool_gather_plan`` writes the plan's integers."""


POOL_CHUNK = 32
"""Features a step of ``pool_runs_staged`` (lane = feature in its scans)."""


def pool_runs_plan(f: int, elem: int, aligned: bool = True, kind: int = 2,
                   tiled: bool = False) -> dict:
    """``pool_runs``' plan (``csrc/pool2.cu`` ``pool_runs_plan``, mirrored by
    ``t2h_pool_runs_plan``) at width F for values of ``elem`` bytes, x, out
    and the tie values 16-byte aligned or not, of ``kind`` (0 max, 1 mean, 2
    sum, 3 sum split among the tied rows), under K10's tile rule or the mask:
    ``staged`` 1 takes ``pool_runs_staged`` (F a multiple of vec, aligned: a
    warp copies each step's :data:`POOL_CHUNK`-feature slice of its own rows
    into a tile in shared memory, 16 bytes a copy, and stores its rows from
    it), 0 ``pool_runs`` (a lane a feature; also the f32 max under the mask,
    K1 max, which took 1-2% longer staged); vec values a copy; chunk
    features a step; pieces copies a row of a step; tile_bytes a tile's
    bytes (one a warp, three with the tie gate)."""
    if f < 1:
        raise ValueError(f"pool_runs takes F >= 1, got {f}")
    vec = 16 // elem
    staged = aligned and f % vec == 0 and not (elem == 4 and kind == 0 and not tiled)
    return {"staged": int(staged), "vec": vec, "chunk": POOL_CHUNK,
            "pieces": POOL_CHUNK // vec, "tile_bytes": SPAN * POOL_CHUNK * elem}


POOL_RUNS_PLAN_KEYS = ("staged", "vec", "chunk", "pieces", "tile_bytes")
"""The order in which ``t2h_pool_runs_plan`` writes the plan's integers."""

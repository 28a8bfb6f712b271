"""The host-side plans of the bf16 kernels on the TMA and wgmma, in plain
Python: K5's bf16 weight sums (``csrc/reduce_bf16.cu``), K8, K7 and K6 in
bf16 (``csrc/conv_bf16.cu``) and K4 in bf16 (``csrc/level_bf16.cu``). The C
launchers compute the same plans (the functions and configs there of the
same names); the wrappers size their scratch and splits from these, and
``tests/test_torch_tile_plan.py`` emulates them in numpy: every output
element covered once, the sums equal to the plain versions'.

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

"""Procedural digit-like templates (a copy of sqair_tpu/data/synthetic.py,
numpy only), and the font glyph banks of the font data configs.

The two glyph banks that the data configs use at their defaults (256
glyphs of 28 px and of 20 px, seed 0) are stored, rendered once, in
``font_glyphs.npz`` beside this module: ``make_font_digit_bank`` reads
them from there on every machine, so that the same arguments give the same
bytes whatever is installed.  Any other bank is rendered with matplotlib.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

GLYPH_FILE = Path(__file__).with_name("font_glyphs.npz")


def _stamp(canvas: np.ndarray, y: float, x: float, intensity: float, radius: float):
    h, w = canvas.shape
    yy, xx = np.mgrid[0:h, 0:w]
    canvas += intensity * np.exp(-(((yy - y) ** 2 + (xx - x) ** 2) / (2 * radius**2)))


def make_stroke_template(rng: np.random.RandomState, size: int = 28) -> np.ndarray:
    """One digit-like template: 1-3 smooth quadratic strokes."""
    canvas = np.zeros((size, size), np.float32)
    n_strokes = rng.randint(1, 4)
    for _ in range(n_strokes):
        # quadratic bezier with 3 control points in the central region
        pts = rng.uniform(size * 0.15, size * 0.85, size=(3, 2))
        ts = np.linspace(0.0, 1.0, 24)
        for t in ts:
            p = (1 - t) ** 2 * pts[0] + 2 * (1 - t) * t * pts[1] + t**2 * pts[2]
            _stamp(canvas, p[0], p[1], 1.0, rng.uniform(1.0, 1.6))
    canvas = np.clip(canvas / max(canvas.max(), 1e-6), 0.0, 1.0)
    # sharpen to a pen-like profile
    canvas = np.clip(canvas * 1.8 - 0.15, 0.0, 1.0)
    return (canvas * 255).astype(np.uint8)


def make_template_bank(n: int, size: int = 28, seed: int = 0) -> np.ndarray:
    """[n, size, size] uint8 bank of synthetic digit templates."""
    rng = np.random.RandomState(seed)
    return np.stack([make_stroke_template(rng, size) for _ in range(n)])


def stored_font_banks():
    """The (n, size, seed) of every bank in ``GLYPH_FILE``."""
    with np.load(GLYPH_FILE) as f:
        found = [re.fullmatch(r"bank_n(\d+)_size(\d+)_seed(\d+)", k) for k in f.files]
    return sorted(tuple(int(v) for v in m.groups()) for m in found if m)


def make_font_digit_bank(n: int, size: int = 28, seed: int = 0):
    """[n, size, size] uint8 bank of REAL digit glyphs, with random
    scale/shift/rotation jitter — a much closer MNIST stand-in than the
    stroke blobs (no network in this image, so true MNIST is unavailable).

    A bank stored in ``GLYPH_FILE`` is read from it; any other is rendered
    from system fonts via matplotlib (which must be installed), as
    ``render_font_digit_bank``.

    :return: (bank [n, size, size] uint8, labels [n] uint8)
    """
    key = f"n{n}_size{size}_seed{seed}"
    with np.load(GLYPH_FILE) as f:
        if "bank_" + key in f.files:
            return f["bank_" + key], f["labels_" + key]
    return render_font_digit_bank(n, size, seed)


def render_font_digit_bank(n: int, size: int = 28, seed: int = 0):
    """``make_font_digit_bank``'s glyphs rendered with matplotlib: the JAX
    package's renderer.

    :return: (bank [n, size, size] uint8, labels [n] uint8)
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(seed)
    bank = np.zeros((n, size, size), np.uint8)
    labels = np.zeros((n,), np.uint8)
    render_px = 4 * size  # supersample then downsample

    fig = plt.figure(figsize=(1, 1), dpi=render_px)
    try:
        for i in range(n):
            digit = rng.randint(0, 10)
            labels[i] = digit
            fig.clf()
            ax = fig.add_axes([0, 0, 1, 1])
            ax.set_xlim(0, 1), ax.set_ylim(0, 1)
            ax.axis("off")
            ax.set_facecolor("black")
            fig.patch.set_facecolor("black")
            rot = rng.uniform(-20, 20)
            fs = rng.uniform(0.5, 0.72) * render_px
            x, y = rng.uniform(0.38, 0.62), rng.uniform(0.32, 0.5)
            ax.text(
                x, y, str(digit), color="white", fontsize=fs,
                ha="center", va="center",
                rotation=rot, rotation_mode="anchor",
                fontweight=rng.choice(["normal", "bold"]),
            )
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[..., 0]  # grayscale
            # downsample by block averaging
            k = buf.shape[0] // size
            img = buf[: k * size, : k * size].reshape(size, k, size, k).mean((1, 3))
            bank[i] = np.clip(img, 0, 255).astype(np.uint8)
    finally:
        plt.close(fig)
    return bank, labels


def template_dimensions(template: np.ndarray):
    """Tight bounding box of a template (reference: data.py:49-61).

    :return: ((y_start, x_start), (y_size, x_size))
    """

    def dim_coords(proj):
        proj = np.greater(proj, 0.0)
        size = proj.sum()
        start = np.argmax(np.arange(len(proj)) * proj) - size + 1
        return int(start), int(size)

    y_start, y_size = dim_coords(template.sum(1))
    x_start, x_size = dim_coords(template.sum(0))
    return (y_start, x_start), (y_size, x_size)

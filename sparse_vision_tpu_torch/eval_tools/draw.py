"""A small PIL canvas for the port's figures.

The JAX package draws its figures with matplotlib, which the card does not
have; the port draws the same figures with PIL (``PIL.ImageDraw``), at the
pixel size that the JAX figure's ``figsize`` x ``dpi`` gives, with the same
data and other glyphs. It draws what the port's figures need and no more: a
figure title, a grid of panels, each with a title, axis labels and the
limits' tick values, bars, stairs (a filled step outline), polylines with
optional markers, horizontal and vertical lines, a legend, and image tiles
pasted with an integer nearest-neighbour upscale (``tile_pixels``), so that a
tile reads back bitwise. Text is in ``ImageFont.load_default()``; the file is
a PNG.
"""

from __future__ import annotations

import math
import os

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# matplotlib's default colour cycle, for lines and bars in series order
COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
          "#7f7f7f", "#bcbd22", "#17becf")
TITLE_H = 30  # pixels above the panels when the figure has a title
# a plotting panel's margins inside its grid cell: left (tick values and the
# y label), top (title), right, bottom (tick values and the x label)
MARGINS = (64, 22, 12, 40)


def tile_pixels(img: np.ndarray, scale: int) -> np.ndarray:
    """``img`` [H, W, C] as the uint8 RGB tile that ``Panel.image`` pastes: the
    range mapped to [0, 255] (viz._to_display), a single channel repeated to
    three, each pixel repeated ``scale`` times along both axes."""
    from sparse_vision_tpu_torch.eval_tools.viz import _to_display

    disp = _to_display(img)
    if disp.ndim == 2:
        disp = disp[..., None]
    if disp.shape[-1] == 1:
        disp = np.repeat(disp, 3, axis=-1)
    u8 = np.clip(disp * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return np.repeat(np.repeat(u8, scale, axis=0), scale, axis=1)


class Figure:
    def __init__(self, figsize: tuple, dpi: int):
        """A white canvas of matplotlib's pixel size for ``figsize`` inches at
        ``dpi``: int(width · dpi) x int(height · dpi)."""
        self.size = (int(figsize[0] * dpi), int(figsize[1] * dpi))
        self.image = Image.new("RGB", self.size, "white")
        self.draw = ImageDraw.Draw(self.image)
        self.font = ImageFont.load_default()
        self.top = 0

    def text_size(self, text: str) -> tuple:
        x0, y0, x1, y1 = self.draw.textbbox((0, 0), text, font=self.font)
        return x1 - x0, y1 - y0

    def text(self, xy: tuple, text: str, anchor: str = "l", fill="black") -> None:
        """``text`` at ``xy``: its left ("l"), centre ("c") or right ("r") end."""
        w, h = self.text_size(text)
        x = xy[0] - {"l": 0, "c": w // 2, "r": w}[anchor]
        self.draw.text((x, xy[1] - h // 2), text, fill=fill, font=self.font)

    def vtext(self, xy: tuple, text: str) -> None:
        """``text`` rotated a quarter turn, centred on ``xy``."""
        w, h = self.text_size(text)
        im = Image.new("L", (w + 2, h + 4), 0)
        ImageDraw.Draw(im).text((1, 0), text, fill=255, font=self.font)
        im = im.rotate(90, expand=True)
        self.image.paste((0, 0, 0), (xy[0] - im.size[0] // 2, xy[1] - im.size[1] // 2), im)

    def title(self, text: str) -> None:
        """The figure's title, centred above the panels."""
        self.top = TITLE_H
        self.text((self.size[0] // 2, TITLE_H // 2), text, anchor="c")

    def grid(self, rows: int, cols: int) -> list:
        """``rows`` x ``cols`` panels below the title, row by row."""
        return [Panel(self, box) for box in grid_boxes(self.size, self.top, rows, cols)]

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # the fastest deflate level: every eval of a run writes figures
        self.image.save(path, format="PNG", compress_level=1)
        return path


class Panel:
    def __init__(self, fig: Figure, box: tuple):
        self.fig, self.box = fig, box
        x0, y0, x1, y1 = box
        left, top, right, bottom = MARGINS
        self.plot = (x0 + left, y0 + top, max(x0 + left + 1, x1 - right),
                     max(y0 + top + 1, y1 - bottom))
        self.lim = ((0.0, 1.0), (0.0, 1.0))
        self.log = (False, False)

    def axes(self, title: str, xlabel: str, ylabel: str, xlim: tuple, ylim: tuple,
             xlog: bool = False, ylog: bool = False) -> None:
        """Frame the plot area: the title above it, the labels, and each
        axis's limits as its two tick values."""
        self.log = (xlog, ylog)
        self.lim = (_span(xlim, xlog), _span(ylim, ylog))
        fig, (px0, py0, px1, py1) = self.fig, self.plot
        fig.draw.rectangle((px0, py0, px1, py1), outline="black")
        fig.text(((px0 + px1) // 2, py0 - 11), title, anchor="c")
        for v, anchor, x in ((xlim[0], "l", px0), (xlim[1], "r", px1)):
            fig.text((x, py1 + 8), _tick(v), anchor=anchor)
        fig.text(((px0 + px1) // 2, py1 + 26), xlabel, anchor="c")
        for v, y in ((ylim[0], py1 - 6), (ylim[1], py0 + 6)):
            fig.text((px0 - 4, y), _tick(v), anchor="r")
        fig.vtext((self.box[0] + 10, (py0 + py1) // 2), ylabel)

    def _x(self, v) -> np.ndarray:
        return self._map(v, 0, self.plot[0], self.plot[2])

    def _y(self, v) -> np.ndarray:
        return self._map(v, 1, self.plot[3], self.plot[1])

    def _map(self, v, axis: int, p0: int, p1: int) -> np.ndarray:
        v = np.asarray(v, np.float64)
        if self.log[axis]:
            v = np.log10(np.maximum(v, 10.0 ** self.lim[axis][0]))
        lo, hi = self.lim[axis]
        return p0 + (np.clip(v, lo, hi) - lo) / (hi - lo) * (p1 - p0)

    def bars(self, lefts, heights, width, fill: str = COLORS[0], outline=None) -> None:
        lefts = np.asarray(lefts, np.float64)
        x0, x1 = self._x(lefts), self._x(lefts + width)
        y0, y1 = self._y(np.zeros_like(lefts)), self._y(heights)
        for a, b, c, d in zip(x0, x1, y0, y1):
            self.fig.draw.rectangle((a, min(c, d), max(a, b), max(c, d)), fill=fill,
                                    outline=outline)

    def stairs(self, values, edges, fill: str = COLORS[0]) -> None:
        """A filled step outline: ``values[i]`` over [edges[i], edges[i + 1]]."""
        xs, ys = self._x(edges), self._y(values)
        base = float(self._y(0.0))
        pts = [(float(xs[0]), base)]
        for i, y in enumerate(ys):
            pts += [(float(xs[i]), float(y)), (float(xs[i + 1]), float(y))]
        pts.append((float(xs[-1]), base))
        self.fig.draw.polygon(pts, fill=fill, outline=fill)

    def line(self, xs, ys, fill: str = COLORS[0], marker: bool = False,
             dashed: bool = False) -> None:
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        ok = np.isfinite(xs) & np.isfinite(ys)  # a NaN point is left out
        pts = list(zip(self._x(xs[ok]).tolist(), self._y(ys[ok]).tolist()))
        if len(pts) > 1:
            if dashed:
                for a, b in zip(pts[:-1], pts[1:]):
                    _dash(self.fig.draw, a, b, fill)
            else:
                self.fig.draw.line(pts, fill=fill, width=2)
        if marker:
            for x, y in pts:
                self.fig.draw.ellipse((x - 3, y - 3, x + 3, y + 3), fill=fill)

    def hline(self, y: float, fill: str = "gray") -> None:
        py = float(self._y(y))
        _dash(self.fig.draw, (self.plot[0], py), (self.plot[2], py), fill)

    def vline(self, x: float, fill: str = "red") -> None:
        px = float(self._x(x))
        self.fig.draw.line((px, self.plot[1], px, self.plot[3]), fill=fill, width=2)

    def legend(self, entries: list) -> None:
        """``entries`` of (label, colour), stacked in the plot area's top
        right corner."""
        x, y = self.plot[2] - 6, self.plot[1] + 8
        for label, color in entries:
            w, _ = self.fig.text_size(label)
            self.fig.draw.rectangle((x - w - 18, y - 4, x - w - 8, y + 4), fill=color)
            self.fig.text((x, y), label, anchor="r")
            y += 14

    def image(self, img: np.ndarray, title: str) -> tuple:
        """Paste ``img`` [H, W, C] under ``title`` at the largest integer
        upscale that fits the cell (or the smallest integer stride when it
        does not fit at 1); returns (x, y, scale, stride) of the pasted tile."""
        x0, y0, x1, _ = self.box
        self.fig.text(((x0 + x1) // 2, y0 + 9), title, anchor="c")
        x, y, scale, stride = tile_place(self.box, img.shape)
        tile = tile_pixels(img[::stride, ::stride], scale)
        self.fig.image.paste(Image.fromarray(tile), (x, y))
        return x, y, scale, stride


def grid_boxes(size: tuple, top: int, rows: int, cols: int) -> list:
    """The (x0, y0, x1, y1) pixel boxes of a ``rows`` x ``cols`` grid over a
    figure of ``size`` below ``top`` pixels, row by row."""
    w, h = size[0] / cols, (size[1] - top) / rows
    return [(round(c * w), round(top + r * h), round((c + 1) * w), round(top + (r + 1) * h))
            for r in range(rows) for c in range(cols)]


def tile_place(box: tuple, shape: tuple) -> tuple:
    """(x, y, scale, stride) of an image of ``shape`` [H, W, ...] pasted in the
    cell ``box`` under its title: the largest integer upscale that fits, else
    scale 1 and the smallest integer stride that fits; centred across."""
    x0, y0, x1, y1 = box
    room_w, room_h = x1 - x0 - 8, y1 - y0 - 22
    h, w = shape[:2]
    scale, stride = min(room_w // w, room_h // h), 1
    if scale < 1:
        scale, stride = 1, max(math.ceil(w / max(room_w, 1)), math.ceil(h / max(room_h, 1)))
    tile_w = -(-w // stride) * scale
    return x0 + (x1 - x0 - tile_w) // 2, y0 + 20, scale, stride


def _span(lim: tuple, log: bool) -> tuple:
    lo, hi = float(lim[0]), float(lim[1])
    if log:
        lo, hi = math.log10(max(lo, 1e-300)), math.log10(max(hi, 1e-300))
    if not hi > lo:  # a flat or empty axis
        hi = lo + 1.0
    return lo, hi


def _tick(v: float) -> str:
    return f"{float(v):.3g}"


def _dash(draw, a: tuple, b: tuple, fill, on: float = 6.0, off: float = 4.0) -> None:
    length = math.hypot(b[0] - a[0], b[1] - a[1])
    t = 0.0
    while t < length:
        e = min(t + on, length)
        draw.line((a[0] + (b[0] - a[0]) * t / length, a[1] + (b[1] - a[1]) * t / length,
                   a[0] + (b[0] - a[0]) * e / length, a[1] + (b[1] - a[1]) * e / length),
                  fill=fill, width=2)
        t = e + off

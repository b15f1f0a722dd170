"""Interactive progressive viewer.

Replaces the reference's CUDA<->OpenGL interop front-end (``utils/cuda2gl.h``
+ ``renderToGL``, ``main.cu:489-528``) with a headless path: render
on device, gather the framebuffer to the host (the BASELINE "framebuffer
gather-to-host" requirement), and present it in the terminal with ANSI
half-block cells. WASD/QE moves the camera (``processInput``,
``main.cu:388-408``), ESC/q quits; the title line shows resolution + FPS
(``fpsCount``, ``main.cu:342-360``).

Improvement over the reference (SURVEY §7 quirk table): the reference
re-renders 100 spp from scratch every frame; this viewer accumulates samples
progressively across frames while the camera is still, restarting
accumulation on movement.

The frame/accumulation logic lives in :class:`ViewerSession` (pure, testable
without a terminal); ``run_viewer`` adds raw-mode stdin + ANSI output.
"""
from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from pathtracer_tpu.config import RenderConfig
from pathtracer_tpu.core.camera import Camera, Direction, move_camera

_KEYMAP = {
    "w": Direction.FORWARD, "s": Direction.BACKWARD,
    "a": Direction.LEFT, "d": Direction.RIGHT,
    "q": Direction.UP, "e": Direction.DOWN,
}


class ViewerSession:
    """Progressive accumulation + camera state machine."""

    def __init__(self, scene, cam: Camera, cfg: RenderConfig,
                 spp_per_frame: int = 2):
        from pathtracer_tpu.render.renderer import _cached_renderer
        self.scene = scene
        self.cam = cam
        self.base_cfg = cfg
        self.frame_cfg = cfg.replace(spp=spp_per_frame)
        self.bvh = None
        if cfg.accel == "bvh":
            from pathtracer_tpu.accel.lbvh import build_lbvh
            self.bvh = build_lbvh(scene)
        self._render = _cached_renderer(self.frame_cfg, self.bvh is not None)
        self._acc: Optional[np.ndarray] = None  # linear-light sum of passes
        self._passes = 0

    def handle_key(self, key: str, delta_time: float) -> bool:
        """Apply a key; returns True if the camera moved (restart accum)."""
        d = _KEYMAP.get(key.lower())
        if d is None:
            return False
        self.cam = move_camera(self.cam, d, delta_time)
        self._acc = None
        self._passes = 0
        return True

    def step(self) -> np.ndarray:
        """Render one pass, fold it into the accumulator, return the current
        gamma-corrected image (H, W, 3) f32, row 0 = bottom."""
        img = np.asarray(
            self._render(self.scene, self.bvh, self.cam,
                         self.base_cfg.seed + self._passes))
        linear = img.astype(np.float64) ** 2  # undo gamma-2 for averaging
        if self._acc is None:
            self._acc = linear
        else:
            self._acc += linear
        self._passes += 1
        return np.sqrt(self._acc / self._passes).astype(np.float32)

    @property
    def passes(self) -> int:
        return self._passes


# Fixed-width cell template: zero-padded color components keep every cell
# exactly 41 bytes, so the whole frame assembles as ONE preallocated uint8
# buffer with vectorized digit stores (a per-pixel Python f-string loop is
# pathological beyond preview sizes; np.char.add is no faster). ANSI
# accepts leading zeros in SGR parameters.
_CELL = np.frombuffer(
    "\x1b[38;2;000;000;000m\x1b[48;2;000;000;000m▀".encode(), np.uint8)
_EOL = np.frombuffer(b"\x1b[0m\n", np.uint8)
_DIGIT_POS = (7, 11, 15, 26, 30, 34)  # tR tG tB bR bG bB start offsets


def _ansi_frame(img: np.ndarray) -> str:
    """Render (H, W, 3) f32 row-0-bottom to ANSI half-block text."""
    h, w = img.shape[:2]
    rgb = (np.clip(img[::-1], 0.0, 0.999) * 256).astype(np.uint8)
    if h % 2:
        rgb = rgb[:-1]
    h2 = rgb.shape[0] // 2
    buf = np.empty((h2, w * len(_CELL) + len(_EOL)), np.uint8)
    cells = buf[:, :w * len(_CELL)].reshape(h2, w, len(_CELL))
    cells[:] = _CELL
    buf[:, w * len(_CELL):] = _EOL
    comps = np.concatenate([rgb[0::2], rgb[1::2]], axis=2)  # (h2, w, 6)
    for i, pos in enumerate(_DIGIT_POS):
        v = comps[..., i].astype(np.uint16)
        cells[..., pos] = v // 100 + 48
        cells[..., pos + 1] = v // 10 % 10 + 48
        cells[..., pos + 2] = v % 10 + 48
    return buf.tobytes()[:-1].decode()  # drop the trailing newline


def run_viewer(scene, cam: Camera, cfg: RenderConfig,
               max_frames: Optional[int] = None) -> int:
    """Terminal loop. Requires a TTY for input; without one, renders
    ``max_frames`` (default 8) passes and exits (useful headless)."""
    import select
    import termios
    import tty

    # keep the terminal frame small regardless of render size
    sess = ViewerSession(scene, cam, cfg)
    is_tty = sys.stdin.isatty()
    frames = 0
    last = time.perf_counter()
    fps = 0.0
    old_attrs = None
    if is_tty:
        old_attrs = termios.tcgetattr(sys.stdin)
        tty.setcbreak(sys.stdin.fileno())
    try:
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            img = sess.step()
            now = time.perf_counter()
            dt = now - last
            fps = 0.9 * fps + 0.1 * (1.0 / max(dt, 1e-6))
            last = now
            sys.stdout.write("\x1b[H")
            sys.stdout.write(
                f"({cfg.width} x {cfg.height}) - FPS: {fps:.2f} - "
                f"passes: {sess.passes}  [wasd/qe move, x quit]\n")
            sys.stdout.write(_ansi_frame(img) + "\n")
            sys.stdout.flush()
            frames += 1
            if max_frames is not None and frames >= max_frames:
                return 0
            if not is_tty and frames >= 8:
                return 0
            if is_tty:
                r, _, _ = select.select([sys.stdin], [], [], 0.0)
                if r:
                    key = sys.stdin.read(1)
                    if key in ("x", "\x1b"):
                        return 0
                    sess.handle_key(key, dt)
    finally:
        if old_attrs is not None:
            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, old_attrs)

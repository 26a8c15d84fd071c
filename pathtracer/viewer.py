"""Interactive terminal viewer: the reference's windowed loop, headless.

The reference opens a GLFW window with mouse-look + WASD and resets
accumulation on movement (main.cpp:662-731, camera.cpp). On a headless
host the equivalent surface is the terminal: frames render on the
device, downsample to character cells, and draw as ANSI truecolor
half-blocks (each glyph = 2 vertical pixels via U+2580 with separate
fg/bg colors). Input is raw-mode stdin: WASD + QE translate, arrows or
IJKL look, +/- speed, ESC/x quits - same camera semantics (speed,
sensitivity, pitch clamp) as render/camera.py, so moving resets
accumulation exactly like the reference.

Pure-python; only the input loop needs a tty (the frame formatter is
unit-testable without one).
"""

from __future__ import annotations

import select
import sys
import time

import numpy as np


def downsample(img: np.ndarray, cols: int, rows_px: int) -> np.ndarray:
    """Box-average u8/f32 [H,W,3] to at most (rows_px, cols) pixels.

    Integer box filter (exact mean over h x w boxes); output height is
    even (half-block glyphs pack 2 pixels vertically).
    """
    h, w = img.shape[:2]
    out_w = max(2, min(cols, w))
    out_h = max(2, min(rows_px, h))
    out_h -= out_h % 2
    ys = (np.arange(out_h + 1) * h) // out_h
    xs = (np.arange(out_w + 1) * w) // out_w
    acc = np.add.accumulate(np.add.accumulate(
        img.astype(np.float64), axis=0), axis=1)
    acc = np.pad(acc, ((1, 0), (1, 0), (0, 0)))
    sums = (acc[ys[1:], :, :][:, xs[1:], :] - acc[ys[:-1], :, :][:, xs[1:], :]
            - acc[ys[1:], :, :][:, xs[:-1], :]
            + acc[ys[:-1], :, :][:, xs[:-1], :])
    areas = ((ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :])
    return sums / areas[..., None]


def frame_to_ansi(img: np.ndarray, cols: int = 80, rows: int = 24) -> str:
    """Render u8-range [H,W,3] to ANSI truecolor half-block text.

    rows = character rows (2 pixels each). Returns the frame body only
    (no cursor control) - the caller positions the cursor.
    """
    px = downsample(np.clip(img, 0, 255), cols, rows * 2)
    px = np.clip(px + 0.5, 0, 255).astype(np.uint8)
    h = px.shape[0]
    lines = []
    for y in range(0, h, 2):
        top, bot = px[y], px[y + 1]
        parts = []
        prev = None
        for t, b in zip(top, bot):
            code = (int(t[0]), int(t[1]), int(t[2]),
                    int(b[0]), int(b[1]), int(b[2]))
            if code != prev:   # skip redundant SGR runs
                parts.append(f"\x1b[38;2;{code[0]};{code[1]};{code[2]}m"
                             f"\x1b[48;2;{code[3]};{code[4]};{code[5]}m")
                prev = code
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


_KEY_HELP = ("WASD+QE move | arrows/IJKL look | +/- speed | "
             "n denoise | t tonemap | ESC/x quit")


def _read_keys(timeout: float):
    """Drain pending stdin bytes (raw mode); decode arrow escapes.

    Reads via unbuffered os.read on the fd that select() watches -
    sys.stdin's buffered layer slurps whole escape sequences into
    userspace, after which select() reports the fd empty and the
    sequence tail would be stranded (or, at pipe EOF, spin forever).
    """
    import os

    keys = []
    fd = sys.stdin.fileno()

    def readable(t):
        r, _, _ = select.select([fd], [], [], t)
        return bool(r)

    def read1():
        return os.read(fd, 1).decode("ascii", errors="ignore")

    while True:
        if not readable(timeout):
            return keys
        ch = read1()
        if ch == "":                     # EOF (scripted/piped stdin)
            return keys
        if ch == "\x1b":
            # Parse a full CSI/SS3 sequence up to its final byte
            # (0x40-0x7e) so modified arrows / Home / F-keys are
            # consumed whole instead of leaking tail bytes as WASD
            # commands. A bare ESC (nothing pending) quits.
            if not readable(0.01):
                keys.append("esc")
                timeout = 0.0
                continue
            lead = read1()
            if lead not in ("[", "O"):
                keys.append("esc")       # ESC + ordinary key: treat as ESC
                timeout = 0.0
                continue
            seq = ""
            while readable(0.01):
                b = read1()
                if b == "":
                    break
                seq += b
                if "\x40" <= b <= "\x7e":   # CSI final byte
                    break
            fin = seq[-1:] if seq else ""
            # unmodified or modified arrows both end in A/B/C/D
            keys.append({"A": "up", "B": "down",
                         "C": "right", "D": "left"}.get(fin, ""))
        else:
            keys.append(ch.lower())
        timeout = 0.0   # drain without further blocking


def run_interactive(renderer, cols: int = 100, rows: int = 40,
                    max_frames: int = 0) -> int:
    """Drive a Renderer from the terminal. Returns frames rendered.

    renderer: pathtracer.render.Renderer (owns scene/cfg/camera/film).
    max_frames: stop after N frames (0 = until quit) - for scripting.
    """
    import termios
    import tty

    cam = renderer.camera
    fd = sys.stdin.fileno()
    try:
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        has_tty = True
    except termios.error:      # piped stdin: render-only preview
        old = None
        has_tty = False
    n = 0
    try:
        sys.stdout.write("\x1b[2J")        # clear once
        t_prev = time.perf_counter()
        while True:
            now = time.perf_counter()
            dt = min(now - t_prev, 0.25)
            t_prev = now
            for k in (_read_keys(0.0) if has_tty else ()):
                if k in ("esc", "x"):
                    raise KeyboardInterrupt
                elif k == "w":
                    cam.process_keyboard("forward", dt)
                elif k == "s":
                    cam.process_keyboard("backward", dt)
                elif k == "a":
                    cam.process_keyboard("left", dt)
                elif k == "d":
                    cam.process_keyboard("right", dt)
                elif k == "q":
                    cam.process_keyboard("down", dt)
                elif k == "e":
                    cam.process_keyboard("up", dt)
                elif k in ("left", "j"):
                    cam.process_mouse(-40.0, 0.0)
                elif k in ("right", "l"):
                    cam.process_mouse(40.0, 0.0)
                elif k in ("up", "i"):
                    cam.process_mouse(0.0, 40.0)
                elif k in ("down", "k"):
                    cam.process_mouse(0.0, -40.0)
                elif k == "n":
                    renderer.denoise = (not renderer.denoise
                                        and renderer.cfg.denoise)
                elif k == "t":
                    modes = ("gamma", "reinhard", "aces")
                    renderer.tonemap = modes[
                        (modes.index(renderer.tonemap) + 1) % len(modes)]
                elif k == "+":
                    cam.speed *= 1.5
                elif k == "-":
                    cam.speed /= 1.5
            film = renderer.step()
            n += 1
            img = np.asarray(renderer.display()) * 255.0
            body = frame_to_ansi(img, cols, rows - 1)
            frame_no = int(film.frame)
            sys.stdout.write("\x1b[H" + body +
                             f"\x1b[0m\nframe {frame_no:4d}  "
                             f"spp {frame_no * renderer.cfg.spp:5d}  "
                             f"{_KEY_HELP}\x1b[K")
            sys.stdout.flush()
            if max_frames and n >= max_frames:
                return n
    except KeyboardInterrupt:
        return n
    finally:
        if old is not None:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")

"""Drive the interactive viewer on the GPU through a pty: let it
accumulate frames, send WASD camera moves (which restart accumulation),
then quit with 'x'. Prints every title line (FPS + passes) seen."""
import os
import pty
import re
import select
import subprocess
import sys
import time

cmd = [sys.executable, "-m", "pathtracer_tpu", "--interactive",
       "--scene", "bunny", "--width", "128", "--height", "72",
       "--spp", "8", "--max-depth", "6",
       "--ray-chunk", "9216"]
master, slave = pty.openpty()
proc = subprocess.Popen(cmd, stdin=slave, stdout=slave, stderr=slave,
                        cwd=os.path.dirname(os.path.dirname(
                            os.path.abspath(__file__))), close_fds=True)
os.close(slave)

buf = b""
titles = []
keys = ["w", "w", "a", "d", "s", "e", "q"]
sent = 0
frames_since_key = 0
deadline = time.time() + 1200
try:
    while time.time() < deadline:
        r, _, _ = select.select([master], [], [], 5.0)
        if not r:
            if proc.poll() is not None:
                break
            continue
        try:
            chunk = os.read(master, 65536)
        except OSError:
            break
        if not chunk:
            break
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            txt = re.sub(rb"\x1b\[[0-9;]*[A-Za-z]", b"", line)
            m = re.search(rb"FPS: ([0-9.]+) - passes: (\d+)", txt)
            if m:
                titles.append((float(m.group(1)), int(m.group(2))))
                print(f"frame: FPS {m.group(1).decode()} "
                      f"passes {m.group(2).decode()} "
                      f"(keys sent: {sent})", flush=True)
                frames_since_key += 1
                # after 12 accumulation frames, start moving the camera
                # every 4 frames; quit after all keys + 10 more frames
                if sent < len(keys) and len(titles) >= 12 \
                        and frames_since_key >= 4:
                    os.write(master, keys[sent].encode())
                    print(f">>> sent key {keys[sent]!r}", flush=True)
                    sent += 1
                    frames_since_key = 0
                elif sent == len(keys) and frames_since_key >= 10:
                    os.write(master, b"x")
                    print(">>> sent quit", flush=True)
                    sent += 1
    proc.wait(timeout=60)
finally:
    if proc.poll() is None:
        proc.terminate()
print(f"exit code: {proc.returncode}, frames seen: {len(titles)}")
if titles:
    steady = [f for f, _ in titles[4:]] or [f for f, _ in titles]
    print(f"FPS: first {titles[0][0]:.2f}, max {max(f for f, _ in titles):.2f}, "
          f"mean(after warmup) {sum(steady)/len(steady):.2f}")
    # passes reset to 1 right after each camera move (accumulation restart)
    resets = sum(1 for i in range(1, len(titles))
                 if titles[i][1] < titles[i - 1][1])
    print(f"accumulation restarts observed (camera moves): {resets}")

r"""One closed-loop client of the ``serve_http`` driver, in a process of its
own apart from the server, as a remote client would be: numpy and
``a3gc_tpu_torch.client`` only (no torch, no card), on the ``cores`` the
parent gives it (off the cores the server's threads run on).

The client makes the run's IMU pool from the seed itself, warms its
connection up (a slot, two windows, the release), reports ready, and at
the window's opening streams sequences: acquire a slot, one ``step`` per
window of the sequence, release, the next sequence. It sends no request
after the deadline. It keeps the poses of the sequences at its drawn
positions and of the longest it finished, and reports its requests' times,
counts and those poses to the parent.
"""

from __future__ import annotations

import os
import time


def main(conn, host: str, port: int, index: int, seed: int, mix: dict,
         stats_path: str, cores):
    import numpy as np

    from a3gc_tpu_torch.client import PoseClient
    from portbench import traffic

    os.sched_setaffinity(0, cores)
    with np.load(stats_path) as z:
        stats = {k: z[k] for k in z.files}
    ori, acc = traffic.imu_pool(seed, mix["pool"], stats)
    W = int(mix["window"])
    counts = traffic.stratified(**mix["windows_per_sequence"])
    requests = traffic.sequences(seed, 100 + index, counts * W, mix["pool"])
    drawn = traffic.drawn_positions(seed, 100 + index,
                                    mix["sample"]["among"],
                                    mix["sample"]["drawn"])

    client = PoseClient(host, port)
    client.acquire()
    for _ in range(2):
        client.step(ori[0, :W], acc[0, :W])
    client.release()
    conn.send("ready")
    _, t_open, deadline = conn.recv()
    time.sleep(max(0.0, t_open - time.monotonic()))

    rtt, kept, longest = [], [], None
    attempted = failed = frames = pos = 0
    errors = []
    last = t_open
    while time.monotonic() < deadline:
        p, off, n = next(requests)
        poses = []
        try:
            attempted += 1
            client.acquire()
            for k in range(n // W):
                if time.monotonic() >= deadline:
                    break
                lo = off + k * W
                attempted += 1
                t0 = time.monotonic()
                pose = client.step(ori[p, lo:lo + W], acc[p, lo:lo + W])
                t1 = last = time.monotonic()
                rtt.append((t0, t1))
                frames += W
                poses.append(pose)
            else:
                attempted += 1
                client.release()
                whole = (pos, (p, off, n), np.concatenate(poses))
                if pos in drawn:
                    kept.append(whole)
                if longest is None or n > longest[1][2]:
                    longest = whole
        except Exception as e:      # counted, and the loop goes on
            failed += 1
            errors.append(repr(e)[:300])
            try:
                client.release()
            except Exception as e2:
                errors.append(repr(e2)[:300])
        pos += 1
    if client.slot is not None:     # a sequence cut by the deadline
        try:
            client.release()
        except Exception as e:
            errors.append(repr(e)[:300])
    client.close()
    conn.send({"rtt": np.asarray(rtt, np.float64).reshape(-1, 2),
               "frames": frames, "attempted": attempted, "failed": failed,
               "errors": errors[:5], "last": last, "kept": kept,
               "longest": longest})
    conn.close()

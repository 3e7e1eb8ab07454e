#!/usr/bin/env python
"""Kill-and-resume smoke of the port's launcher: SIGTERM it mid-run,
resume, and require a bitwise-identical trajectory.

Drives ``python -m repro_torch.launch.train`` three times (``--smoke``,
n=8, the Markov channel, telemetry on; by default 32 rounds in chunks of
8):

1. **reference**: uninterrupted; its ``rounds.csv`` is the golden
   trajectory.
2. **victim**: the same run in fresh directories, checkpointing every
   chunk (``--ckpt-dir --ckpt-every K``); SIGTERM is sent once the second
   chunk's line appears on stdout.  The launcher's PreemptionGuard must
   latch the signal, commit a final checkpoint at the next chunk
   boundary, print the preemption notice and exit 0.
3. **resume**: ``--resume`` against the victim's directories, to the same
   total.

The resumed run's ``rounds.csv`` must equal the reference's byte for byte
(the CSV sink trims to the checkpoint's round on resume, so each round is
logged once), and the final committed checkpoint must be the last round's.
Exit 0 on success, 1 on any deviation.

    PYTHONPATH=src python tools/torch_kill_resume_smoke.py [--device cuda] \\
        [--rounds 32] [--chunk 8]
"""

import argparse
import os
import pathlib
import signal
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent


def launch(flags, *, kill_after_chunks=None, timeout=600):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *flags]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO / "src"), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)
    out, chunks = [], 0
    try:
        for line in proc.stdout:
            out.append(line)
            sys.stdout.write("  | " + line)
            if kill_after_chunks is not None and line.startswith("rounds "):
                chunks += 1
                if chunks == kill_after_chunks:
                    proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, "".join(out)


class Failed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def run(device, rounds, chunk, workdir) -> int:
    """The three launches, their directories under ``workdir``; returns the
    number of rounds compared, raises :class:`Failed` on a deviation."""
    tmp = pathlib.Path(workdir)
    ref_m, vic_m, ck = tmp / "ref_metrics", tmp / "metrics", tmp / "ckpt"
    flags = ["--smoke", "--n-clients", "8", "--rounds", str(rounds), "--chunk", str(chunk),
             "--channel", "markov", "--seed", "0"]
    if device is not None:
        flags += ["--device", device]

    print("== reference (uninterrupted) ==")
    rc, _ = launch([*flags, "--metrics-dir", str(ref_m)])
    check(rc == 0, f"reference run exited {rc}")

    print("== victim (SIGTERM after chunk 2) ==")
    ckpt_flags = ["--metrics-dir", str(vic_m), "--ckpt-dir", str(ck), "--ckpt-every", str(chunk)]
    rc, out = launch([*flags, *ckpt_flags], kill_after_chunks=2)
    check(rc == 0, f"victim run exited {rc}; preemption must drain and exit clean")
    check("[ckpt] preempted" in out, "victim run never reported the latched preemption")
    committed = sorted(p.name for p in ck.glob("*.sha256"))
    check(bool(committed), "victim run committed no checkpoint")
    check(f"ckpt_{rounds:08d}.pt.sha256" not in committed,
          "the victim ran to the end: the signal was not latched mid-run")
    print(f"  committed after kill: {committed}")

    print("== resume ==")
    rc, out = launch([*flags, *ckpt_flags, "--resume"])
    check(rc == 0, f"resumed run exited {rc}")
    check("resuming from" in out, "resumed run never reported its checkpoint source")
    check((ck / f"ckpt_{rounds:08d}.pt.sha256").exists(),
          f"resumed run did not commit the final round-{rounds} checkpoint")

    ref = (ref_m / "rounds.csv").read_bytes()
    got = (vic_m / "rounds.csv").read_bytes()
    check(ref == got, "resumed rounds.csv differs from the uninterrupted run")
    n_rows = len(ref.splitlines()) - 1
    check(n_rows == rounds, f"rounds.csv holds {n_rows} rounds, expected {rounds}")
    return n_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="passed to the launcher (default: CUDA)")
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=8)
    args = ap.parse_args(argv)
    try:
        with tempfile.TemporaryDirectory(prefix="torch_kill_resume_smoke_") as tmp:
            n_rows = run(args.device, args.rounds, args.chunk, tmp)
    except Failed as e:
        print(f"FAIL: {e}")
        return 1
    print(f"PASS: {n_rows} rounds bitwise-identical across kill/resume")
    return 0


if __name__ == "__main__":
    sys.exit(main())

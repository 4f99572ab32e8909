"""Subprocess serve driver for SIGKILL soaks on `krr_tpu_torch`
(`tests.fakes.torch_chaos.run_kill_soak`).

The counterpart of `tests/fakes/soak_driver.py` on the port: runs a REAL
``krr_tpu_torch`` ``KrrServer`` composition (durable store, journal,
scheduler, HTTP listener) against the fake backend the parent process is
serving, and ticks a scripted fake-clock schedule — printing ``TICK <i> ...``
after each scheduler round and ``DONE`` at the end, so the parent can aim
SIGKILLs at random points and detect completion. Because the schedule is
absolute tick TIMES and the serve cursor persists in the durable store, a
restarted driver skips the already-folded windows and resumes exactly where
the killed process's last durable publish left off.

Usage: ``python -m tests.fakes.torch_soak_driver CONFIG.json`` where the
JSON holds ``{"config": <Config kwargs>, "ticks": [unix times...]}``. The
compute device is the config's ``device`` (the port's ``Config`` defaults
to ``cuda``; a soak on the CPU passes ``"device": "cpu"``).
"""

from __future__ import annotations

import asyncio
import json
import sys


def main() -> None:
    with open(sys.argv[1]) as f:
        payload = json.load(f)

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.server.app import KrrServer

    config = Config(**payload["config"])
    ticks = [float(t) for t in payload["ticks"]]
    now = [ticks[0]]

    async def run() -> None:
        server = KrrServer(config, clock=lambda: now[0])
        await server.start(run_scheduler=False)
        try:
            for i, t in enumerate(ticks):
                now[0] = t
                ok = await server.scheduler.run_once()
                print(f"TICK {i} ok={ok}", flush=True)
        finally:
            await server.shutdown()

    asyncio.run(run())
    print("DONE", flush=True)


if __name__ == "__main__":
    main()

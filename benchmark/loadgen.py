"""The open-loop load generator: one process, one thread, one asyncio loop.

Each request is sent at its due time on a connection of its own, whether or
not earlier ones have been answered, and read to the end: ``POST /sample``
with one npz body and an ``X-Request-Id`` header. The parent sends the
schedule and the bodies, then the start time on the shared monotonic clock;
the generator answers with one record per request (id, due, sent, done,
HTTP status, whether the body is a whole PDB) and keeps the bodies until the
parent asks for some of them.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Sequence, Tuple

Record = Tuple[int, float, float, float, int, bool]


async def _one(host, port, rid: int, due: float, body: bytes, out: list, bodies: Dict[int, bytes],
               timeout: float):
    await asyncio.sleep(max(0.0, due - time.monotonic()))
    sent = time.monotonic()
    status, ok = -1, False
    try:
        await asyncio.wait_for(_exchange(host, port, rid, body, bodies), timeout)
        status, ok = bodies.pop(("status", rid))
    except (OSError, ValueError, IndexError, asyncio.TimeoutError):
        pass
    out.append((rid, due, sent, time.monotonic(), status, ok))


async def _exchange(host, port, rid: int, body: bytes, bodies: dict):
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(b"POST /sample HTTP/1.1\r\nHost: %s\r\nContent-Length: %d\r\n"
                     b"X-Request-Id: %d\r\nConnection: close\r\n\r\n"
                     % (host.encode(), len(body), rid) + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    bodies[rid] = payload
    bodies[("status", rid)] = (status, status == 200 and payload.rstrip().endswith(b"END"))


async def _run(host, port, schedule, bodies_in, start: float, drain_s: float):
    out: List[Record] = []
    bodies: Dict[int, bytes] = {}
    end = max(offset for offset, _ in schedule)
    await asyncio.gather(*[_one(host, port, rid, start + offset, bodies_in[i], out, bodies,
                                end - offset + drain_s)
                           for rid, (offset, i) in enumerate(schedule)])
    return out, bodies


def main(conn) -> None:
    """Serve the parent over ``conn``: ``("load", host, port, schedule,
    bodies)`` then ``start``: run it and send the records; ``("bodies",
    ids)``: send those bodies; ``None``: exit."""
    bodies: Dict[int, bytes] = {}
    while True:
        msg = conn.recv()
        if msg is None:
            return
        if msg[0] == "load":
            _, host, port, schedule, bodies_in, drain_s = msg
            conn.send("ready")
            start = conn.recv()
            records, bodies = asyncio.run(_run(host, port, schedule, bodies_in, start, drain_s))
            records.sort()
            conn.send(records)
        elif msg[0] == "bodies":
            conn.send({i: bodies.get(i, b"") for i in msg[1]})


class LoadGenerator:
    """The generator's process, started with ``spawn`` (one process for the
    whole run); ``close`` ends it and waits for it."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=main, args=(child,), daemon=True)
        self.proc.start()

    def run(self, host: str, port: int, schedule: Sequence[Tuple[float, int]],
            bodies: Sequence[bytes], drain_s: float,
            lead_s: float = 0.5) -> Tuple[float, List[Record]]:
        """Send ``schedule`` ((offset s, body index) per request, the id its
        position) from a start ``lead_s`` ahead, each request given until
        ``drain_s`` after the last one is due; returns (start, records)."""
        self.conn.send(("load", host, port, list(schedule), list(bodies), drain_s))
        self.conn.recv()
        start = time.monotonic() + lead_s
        self.conn.send(start)
        return start, self.conn.recv()

    def bodies(self, ids) -> Dict[int, bytes]:
        self.conn.send(("bodies", list(ids)))
        return self.conn.recv()

    def close(self) -> None:
        try:
            self.conn.send(None)
        except OSError:
            pass
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)

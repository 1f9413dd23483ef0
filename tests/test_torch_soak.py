"""The port's soak world: the reference's ``SoakTestWorld``
(``tests/test_soak.py``) on ``downloader_tpu_torch.soak`` — whose rig
spawns ``python -m downloader_tpu_torch`` workers — the port's S3 store
and the port's broker copy (``tests/test_torch_miniamqp.py``), with the
reference's loopback origins and MiniS3, which import nothing of either
package.

The port's CLI (``incident replay``) and fuzzer import
:class:`SoakTestWorld` from here, as the reference's import it from
``test_soak``.  ``test_soak_smoke`` is the reference's tier-1 capacity
gate on the port's fleet: a real 2-worker fleet under the mixed workload
with at least one SIGKILL, every SLO guard green.  The reference's soak
unit tests vouch for ``downloader_tpu_torch/soak/`` through the copy
check (``tests/test_torch_service_copies.py``), which also holds every
definition here to the reference's.
"""

import asyncio
import json
import os

import pytest
from aiohttp import web

from downloader_tpu_torch.soak import (SoakEndpoints, SoakProfile, SoakRig,
                                       SoakWorkload, WorkloadOrigin)
from downloader_tpu_torch.store.s3 import S3ObjectStore

from helpers import RangeOrigin, start_http_server
from minis3 import MiniS3
from test_torch_miniamqp import MiniAmqpServer

pytestmark = pytest.mark.anyio

STAGING = "triton-staging"


class HotOrigin:
    """One cacheable payload with an ETag — the shared fan-in key."""

    def __init__(self, size=384 << 10, name="hot.mkv"):
        self.payload = os.urandom(size)
        self.name = name
        self.requests = 0
        self._runner = None
        self.url = None

    async def _serve(self, request):
        headers = {"ETag": '"soak-hot-1"',
                   "Content-Length": str(len(self.payload)),
                   "Accept-Ranges": "bytes"}
        if request.method == "HEAD":
            return web.Response(headers=headers)
        self.requests += 1
        return web.Response(body=self.payload,
                            headers={"ETag": '"soak-hot-1"'})

    async def start(self):
        self._runner, base = await start_http_server(
            self._serve, path=f"/{self.name}")
        self.url = f"{base}/{self.name}"
        return self.url

    async def stop(self):
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None


class FileSetOrigin:
    """Distinct cacheable payloads at ``/files/<name>``."""

    def __init__(self, count=6, size=160 << 10, prefix="p"):
        self.files = {f"{prefix}{i}.mkv": os.urandom(size)
                      for i in range(count)}
        self._runner = None
        self.base = None

    async def _serve(self, request):
        name = request.match_info["name"]
        payload = self.files.get(name)
        if payload is None:
            return web.Response(status=404)
        return web.Response(body=payload,
                            headers={"ETag": f'"soak-{name}"'})

    async def start(self):
        app = web.Application()
        app.router.add_get("/files/{name}", self._serve)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        self._runner = runner
        self.base = f"http://127.0.0.1:{port}"
        return self.base

    def origin(self, name) -> WorkloadOrigin:
        return WorkloadOrigin(uri=f"{self.base}/files/{name}",
                              files=((name, self.files[name]),))

    async def stop(self):
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None


class VodOrigin:
    """An ended HLS-style playlist: the manifest ingest's VOD path."""

    def __init__(self, index=0, segments=4, seg_bytes=48 << 10):
        self.prefix = f"v{index}"
        self.segments = [os.urandom(seg_bytes) for _ in range(segments)]
        self._runner = None
        self.url = None

    async def _playlist(self, _request):
        lines = ["#EXTM3U", "#EXT-X-TARGETDURATION:1",
                 "#EXT-X-MEDIA-SEQUENCE:0"]
        for i in range(len(self.segments)):
            lines.append("#EXTINF:0.5,")
            lines.append(f"{self.prefix}seg{i:04d}.ts")
        lines.append("#EXT-X-ENDLIST")
        return web.Response(text="\n".join(lines))

    async def _segment(self, request):
        return web.Response(
            body=self.segments[int(request.match_info["i"])])

    async def start(self):
        app = web.Application()
        app.router.add_get(f"/{self.prefix}.m3u8", self._playlist)
        app.router.add_get(
            r"/%sseg{i:\d+}.ts" % self.prefix, self._segment)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        self._runner = runner
        self.url = f"http://127.0.0.1:{port}/{self.prefix}.m3u8"
        return self.url

    def origin(self) -> WorkloadOrigin:
        return WorkloadOrigin(
            uri=self.url, source_kind="MANIFEST",
            files=tuple((f"{self.prefix}seg{i:04d}.ts", payload)
                        for i, payload in enumerate(self.segments)))

    async def stop(self):
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None


class SoakTestWorld:
    """Backends + origins + the port's rig for one soak run (the port's
    soak smoke, its CLI's ``incident replay`` and its fuzzer)."""

    def __init__(self):
        self.amqp = None
        self.s3 = None
        self.store = None
        self.origins = []
        self.rig = None
        self.workload = None

    @classmethod
    async def create(cls, root: str, profile: SoakProfile
                     ) -> "SoakTestWorld":
        world = cls()
        world.amqp = MiniAmqpServer()
        await world.amqp.start()
        world.s3 = MiniS3()
        s3_url = await world.s3.start()
        world.store = S3ObjectStore(s3_url, "AKIA", "SECRET")
        await world.store.make_bucket(STAGING)

        hot = HotOrigin()
        await hot.start()
        plain = FileSetOrigin()
        await plain.start()
        racing_pairs = []
        for i in range(2):
            payload = os.urandom(512 << 10)
            primary = RangeOrigin(payload, rate=600_000.0,
                                  etag=f'"race-{i}"',
                                  path=f"/race{i}.mkv")
            mirror = RangeOrigin(payload, etag=f'"race-{i}"',
                                 path=f"/race{i}.mkv")
            await primary.start()
            await mirror.start()
            racing_pairs.append(WorkloadOrigin(
                uri=primary.url, mirrors=(mirror.url,),
                files=((f"race{i}.mkv", payload),)))
            world.origins.extend([primary, mirror])
        vods = [VodOrigin(index=i) for i in range(2)]
        for vod in vods:
            await vod.start()
        # attribution probe: fresh content, rate-limited so the splice
        # dominates the coordination ceremony (the reconciliation
        # guard's transfer-attributable regime)
        probes = []
        for i in range(profile.probe_jobs):
            payload = os.urandom(2 << 20)
            origin = RangeOrigin(payload, rate=3_000_000.0,
                                 etag=f'"probe-{i}"',
                                 path=f"/probe{i}.mkv")
            await origin.start()
            probes.append(WorkloadOrigin(
                uri=origin.url,
                files=((f"probe{i}.mkv", payload),)))
            world.origins.append(origin)
        world.origins.extend([hot, plain] + vods)

        endpoints = SoakEndpoints(
            hot=(WorkloadOrigin(uri=hot.url,
                                files=((hot.name, hot.payload),)),),
            plain=tuple(plain.origin(name)
                        for name in sorted(plain.files)),
            racing=tuple(racing_pairs),
            manifest=tuple(vod.origin() for vod in vods),
            probe=tuple(probes),
        )
        world.workload = SoakWorkload(profile, endpoints)
        world.rig = SoakRig(
            profile,
            amqp_url=world.amqp.url,
            store=world.store,
            s3_endpoint=f"http://127.0.0.1:{world.s3.port}",
            root=root,
        )
        return world

    async def close(self):
        if self.rig is not None:
            await self.rig.stop_workers()
        for origin in self.origins:
            await origin.stop()
        if self.store is not None:
            await self.store.close()
        if self.s3 is not None:
            await self.s3.stop()
        if self.amqp is not None:
            await self.amqp.stop()


async def _run_soak(tmp_path, profile):
    world = await SoakTestWorld.create(str(tmp_path), profile)
    try:
        async with asyncio.timeout(profile.max_wall + 90):
            report = await world.rig.run(world.workload)
    finally:
        await world.close()
    return world, report


def _explain(report):
    return report.summary() + "\n" + json.dumps(report.to_dict(),
                                                indent=2)


async def test_soak_smoke(tmp_path):
    """The tier-1 capacity gate: mixed workload + ≥1 SIGKILL, every
    SLO guard green (``make soak-smoke``)."""
    profile = SoakProfile.smoke()
    world, report = await _run_soak(tmp_path, profile)

    assert report.ok, _explain(report)
    # the chaos actually happened: at least one true SIGKILL + restart
    assert report.stats["kills_delivered"] >= 1
    # every workload kind resolved (the mix was really exercised)
    for kind in ("hot", "racing", "manifest", "bulk", "plain"):
        kind_outcomes = [o for o in world.rig.outcomes.values()
                         if o.spec.kind == kind]
        assert kind_outcomes, f"no {kind} jobs in the mix"
        assert all(o.resolved_mono is not None for o in kind_outcomes)
    # the growth gauges the guards ride were live on /metrics: some
    # sample scraped a journal_bytes value off a real worker
    assert any(
        sample.metric(slot.index, "journal_bytes") is not None
        for sample in world.rig.samples
        for slot in world.rig.slots
    ), "journal_bytes gauge never appeared on /metrics"
    assert report.stats["journal_peak_bytes"] > 0

"""The port's operator CLI: ``tests/test_cli.py``'s ten tests on
``downloader_tpu_torch.cli``, against the port's service and the port's
broker copy, plus the port's ``incident replay --compile-only`` and its
scenario compiler on the checked-in v1 bundle."""

import asyncio
import json
import os

import pytest

from downloader_tpu_torch import cli, schemas
from downloader_tpu_torch.torrent.magnet import parse_magnet
from downloader_tpu_torch.torrent.metainfo import parse_torrent_bytes

from test_torch_miniamqp import MiniAmqpServer

pytestmark = pytest.mark.anyio

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "incident_bundle_v1.json")


def test_mktorrent_and_magnet_roundtrip(tmp_path, capsys):
    src = tmp_path / "media"
    src.mkdir()
    (src / "a.mkv").write_bytes(os.urandom(40_000))
    out = str(tmp_path / "media.torrent")
    rc = cli.main([
        "mktorrent", str(src),
        "--tracker", "http://t.example/announce",
        "--webseed", "http://ws.example/media/",
        "--piece-length", str(1 << 14),
        "--out", out,
    ])
    assert rc == 0
    with open(out, "rb") as fh:
        meta = parse_torrent_bytes(fh.read())
    assert meta.trackers == ["http://t.example/announce"]
    assert meta.webseeds == ["http://ws.example/media/"]
    assert meta.total_length == 40_000

    rc = cli.main(["magnet", out])
    assert rc == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    magnet = parse_magnet(printed)
    assert magnet.info_hash == meta.info_hash
    assert magnet.trackers == ["http://t.example/announce"]


def test_submit_refuses_memory_backend(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CONFIG_PATH", str(tmp_path))  # no yaml -> defaults
    rc = cli.main([
        "submit", "--id", "j1", "--name", "X",
        "--source", "http", "--uri", "http://h/x.mkv",
    ])
    assert rc == 2
    assert "in-memory queue backend" in capsys.readouterr().err


async def test_submit_publishes_over_amqp(tmp_path, monkeypatch):
    server = await MiniAmqpServer().start()
    try:
        (tmp_path / "converter.yaml").write_text(
            "rabbitmq: {backend: amqp}\n"
            f"services: {{rabbitmq: \"{server.url}\"}}\n"
        )
        monkeypatch.setenv("CONFIG_PATH", str(tmp_path))

        # cli.main runs its own event loop; keep this test's loop free
        rc = await asyncio.to_thread(cli.main, [
            "submit", "--id", "cli-job", "--name", "A Show",
            "--type", "TV", "--source", "torrent",
            "--uri", "magnet:?xt=urn:btih:" + "00" * 20,
        ])
        assert rc == 0

        from downloader_tpu_torch.mq.amqp import AmqpQueue

        got: list = []
        done = asyncio.Event()

        async def handler(delivery):
            got.append(delivery.body)
            await delivery.ack()
            done.set()

        mq = AmqpQueue(server.url, heartbeat=0)
        await mq.connect()
        try:
            await mq.listen(schemas.DOWNLOAD_QUEUE, handler)
            async with asyncio.timeout(10):
                await done.wait()
        finally:
            await mq.close()

        msg = schemas.decode(schemas.Download, got[0])
        assert msg.media.id == "cli-job"
        assert msg.media.source == schemas.SourceType.Value("TORRENT")
    finally:
        await server.stop()


def test_mktorrent_rejects_bad_piece_length(tmp_path, capsys):
    src = tmp_path / "f.mkv"
    src.write_bytes(b"x" * 100)
    with pytest.raises(SystemExit):
        cli.main(["mktorrent", str(src), "--piece-length", "0",
                  "--out", str(tmp_path / "o.torrent")])


def test_submit_flags_case_insensitive(tmp_path, monkeypatch):
    monkeypatch.setenv("CONFIG_PATH", str(tmp_path))
    # lowercase type and uppercase source both parse; memory backend still
    # refuses (rc 2), proving we got past argparse
    rc = cli.main([
        "submit", "--id", "j", "--name", "X", "--type", "movie",
        "--source", "HTTP", "--uri", "http://h/x.mkv",
    ])
    assert rc == 2


async def test_watch_tails_telemetry(tmp_path, monkeypatch, capsys):
    """watch prints status + progress events from the real queue."""
    server = await MiniAmqpServer().start()
    try:
        (tmp_path / "converter.yaml").write_text(
            "rabbitmq: {backend: amqp}\n"
            f"services: {{rabbitmq: \"{server.url}\"}}\n"
        )
        monkeypatch.setenv("CONFIG_PATH", str(tmp_path))

        from downloader_tpu_torch.mq.amqp import AmqpQueue
        from downloader_tpu_torch.platform.telemetry import Telemetry

        async def publish_events():
            mq = AmqpQueue(server.url, heartbeat=0)
            telem = Telemetry(mq)
            await telem.connect()  # engages the fanout exchanges
            try:
                await asyncio.sleep(0.3)  # let watch subscribe first
                await telem.emit_status(
                    "w-job", schemas.TelemetryStatus.Value("DOWNLOADING"))
                await telem.emit_progress(
                    "w-job", schemas.TelemetryStatus.Value("DOWNLOADING"), 50)
            finally:
                await mq.close()

        publisher = asyncio.create_task(publish_events())
        rc = await asyncio.to_thread(
            cli.main, ["watch", "--id", "w-job", "--count", "2"]
        )
        await publisher
        assert rc == 0
        out = capsys.readouterr().out
        assert "w-job\tstatus\tDOWNLOADING" in out
        assert "w-job\tprogress\tDOWNLOADING\t50%" in out
    finally:
        await server.stop()


async def test_cli_scrape(tmp_path, capsys):
    import os as os_mod

    from minitracker import MiniTracker
    from downloader_tpu_torch.torrent import make_metainfo

    tracker = MiniTracker([("127.0.0.1", 9)])
    url = await tracker.start()
    try:
        src = tmp_path / "m.mkv"
        src.write_bytes(os_mod.urandom(30_000))
        meta = make_metainfo(str(src), piece_length=1 << 14, trackers=[url])
        tf = tmp_path / "m.torrent"
        tf.write_bytes(meta.to_torrent_bytes())
        rc = await asyncio.to_thread(cli.main, ["scrape", str(tf)])
        assert rc == 0
        assert "seeders=1" in capsys.readouterr().out
    finally:
        await tracker.stop()


async def _admin_rig(tmp_path):
    """A live port orchestrator + admin server (no broker consumption):
    the rig the status/jobs/trace CLI tests poke over real HTTP."""
    from downloader_tpu_torch.health import start_server
    from downloader_tpu_torch.mq import InMemoryBroker, MemoryQueue
    from downloader_tpu_torch.orchestrator import Orchestrator
    from downloader_tpu_torch.platform import metrics as prom
    from downloader_tpu_torch.platform.config import ConfigNode
    from downloader_tpu_torch.platform.logging import NullLogger
    from downloader_tpu_torch.platform.telemetry import Telemetry

    broker = InMemoryBroker()
    telem_mq = MemoryQueue(broker)
    await telem_mq.connect()
    metrics = prom.new("downloader")
    orch = Orchestrator(
        config=ConfigNode({"instance": {"download_path": str(tmp_path)}}),
        mq=MemoryQueue(broker), store=None,
        telemetry=Telemetry(telem_mq), metrics=metrics, logger=NullLogger(),
    )
    runner = await start_server(orch, metrics=metrics, port=0)
    return orch, runner, runner.addresses[0][1]


async def test_cli_status_against_live_service(tmp_path, capsys):
    _orch, runner, port = await _admin_rig(tmp_path)
    try:
        rc = await asyncio.to_thread(
            cli.main, ["status", "--url", f"http://127.0.0.1:{port}"]
        )
        assert rc == 0
        out = capsys.readouterr().out
        assert "health: idle" in out
        assert "downloader_jobs_consumed_total" in out

        rc = await asyncio.to_thread(
            cli.main, ["status", "--url", "http://127.0.0.1:1"]
        )
        assert rc == 2
    finally:
        await runner.cleanup()


async def test_cli_jobs_events_follow_tails_until_terminal(tmp_path, capsys):
    """``jobs events --follow`` live-tails: events recorded *after* the
    first poll still print, and the loop exits on its own once the job
    settles."""
    from downloader_tpu_torch.control.registry import CANCELLED

    orch, runner, port = await _admin_rig(tmp_path)
    try:
        record = orch.registry.register("job-follow-1", "card")
        record.event("queue_wait", seconds=0.12)
        follow = asyncio.create_task(asyncio.to_thread(
            cli.main,
            ["jobs", "events", "job-follow-1", "--follow",
             "--interval", "0.1", "--url", f"http://127.0.0.1:{port}"],
        ))
        await asyncio.sleep(0.5)
        record.event("settle", outcome="cancelled")
        orch.registry.transition(record, CANCELLED)
        rc = await asyncio.wait_for(follow, 15)
        assert rc == 0
        out = capsys.readouterr().out
        assert "queue_wait" in out          # pre-follow event
        assert "settle" in out              # event recorded mid-follow
        assert "state=RECEIVED" in out      # header shows receipt state
    finally:
        await runner.cleanup()


async def test_cli_trace_show_renders_local_view(tmp_path, capsys):
    """``trace show`` renders the assembled trace (local-only here: no
    fleet plane attached) and exits 1 on an unknown trace id."""
    trace_id = "ab" * 16

    orch, runner, port = await _admin_rig(tmp_path)
    try:
        record = orch.registry.register("job-trace-1", "card")
        record.trace_id = trace_id
        record.span_id = "cd" * 8
        record.event("span", spanId=record.span_id)
        base = f"http://127.0.0.1:{port}"
        rc = await asyncio.to_thread(
            cli.main, ["trace", "show", trace_id, "--url", base])
        assert rc == 0
        out = capsys.readouterr().out
        assert f"# trace {trace_id}" in out
        assert "job-trace-1" in out

        rc = await asyncio.to_thread(
            cli.main, ["trace", "show", "ff" * 16, "--url", base])
        assert rc == 1
    finally:
        await runner.cleanup()


def _fixture_bundle() -> dict:
    with open(FIXTURE, encoding="utf-8") as fh:
        return json.load(fh)


def test_incident_replay_compile_only(capsys):
    """``incident replay --bundle FILE --compile-only`` prints the
    compiled scenario and runs no fleet: the port's compiler's, which is
    the JAX package's on the same bundle."""
    from downloader_tpu.incident import compile_bundle as reference_compile

    rc = cli.main(["incident", "replay", "--bundle", FIXTURE,
                   "--compile-only"])
    assert rc == 0
    scenario = json.loads(capsys.readouterr().out)
    assert scenario == reference_compile(_fixture_bundle())
    assert scenario["profile"]["jobs"] == 18
    assert scenario["faultPlan"]


def test_fixture_compiles_to_the_stalled_leader_scenario():
    """``tests/test_incident.py``'s compiler test on the port: the
    scenario materialises as the port's own ``SoakProfile``."""
    from downloader_tpu_torch.incident import compile_bundle, scenario_profile
    from downloader_tpu_torch.soak.workload import SoakProfile

    scenario = compile_bundle(_fixture_bundle())
    profile = scenario["profile"]
    assert profile["jobs"] == 18
    assert profile["publish_rate"] == 2.5  # 18 jobs / 7.2 s wall
    assert profile["stalls"] == 1  # fencedWrites > 0 => SIGSTOP drill
    assert profile["lease_ttl"] == 2.0
    assert profile["brownout_start_s"] == 1.0
    assert profile["breakers"]["store"]["slow_threshold_ms"] == 120
    soak = scenario_profile(scenario)
    assert type(soak) is SoakProfile
    assert soak.jobs == 18 and soak.stalls == 1
    assert json.loads(soak.fault_plan) == scenario["faultPlan"]

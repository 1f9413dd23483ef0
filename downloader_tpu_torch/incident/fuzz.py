"""Deterministic scenario fuzzer (`make fuzz-scenarios`).

Takes one compiled incident scenario (``compiler.compile_bundle``
output) and breeds seeded variants of it — shifted degradation windows,
swapped fault kinds, scaled job counts, stretched windows, jittered
publish rates — hunting for breach signatures the original incident
never produced.  Opt-in and deliberately NOT a CI job (like
``make soak-full``): executing a variant is a full SoakRig replay, so a
fuzz campaign is minutes-per-variant by construction.

DETERMINISM CONTRACT: every mutation is drawn from ``random.Random``
seeded by the caller; the same ``(scenario, seed, variants)`` triple
yields byte-identical variants on every run and every machine
(tests/test_incident.py::test_fuzz_is_deterministic).  No wall-clock,
no environment, no global RNG — the same discipline as the compiler,
because a fuzz-found breach is only worth filing if the seed replays
it.
"""

import copy
import json
import random
from typing import Dict, List, Optional, Tuple

from ..platform.faults import MODES, WINDOWED_KINDS
from .compiler import (DEFAULT_LEAD_S, REPLAY_JOB_CAP, REPLAY_JOB_FLOOR,
                       scenario_fault_plan_json)

#: sane fuzz-side clamps — wider than the compiler's replay clamps (the
#: point is to explore), still bounded so a variant stays runnable
FUZZ_JOB_FLOOR = max(REPLAY_JOB_FLOOR // 2, 3)
FUZZ_JOB_CAP = REPLAY_JOB_CAP * 2
MIN_RATE, MAX_RATE = 0.5, 8.0
MAX_SHIFT_S = 6.0
MAX_WINDOW_SCALE = 3.0

#: per-kind field defaults a swap must fill in so the mutated rule
#: stays a valid FaultRule (platform/faults.py) of its NEW kind
_KIND_DEFAULTS: Dict[str, Dict[str, object]] = {
    "brownout": {"latency_ms": 400.0, "jitter_ms": 120.0},
    "partition": {"blackhole": False},
    "flap": {"period_s": 2.0, "duty": 0.5},
}


def _windowed_rules(plan: List[dict]) -> List[int]:
    return [i for i, r in enumerate(plan)
            if r.get("kind") in WINDOWED_KINDS]


def _mut_shift_window(scenario: dict, rng: random.Random) -> Optional[str]:
    """Slide one degradation window earlier/later (floored at lead)."""
    plan = scenario["faultPlan"]
    idx = _windowed_rules(plan)
    if not idx:
        return None
    i = rng.choice(idx)
    shift = round(rng.uniform(-MAX_SHIFT_S, MAX_SHIFT_S), 2)
    lead = float(scenario.get("leadS") or DEFAULT_LEAD_S)
    old = float(plan[i].get("start_s", 0.0) or 0.0)
    plan[i]["start_s"] = round(max(old + shift, lead), 2)
    return (f"shift_window[{i}:{plan[i].get('kind')}] "
            f"start_s {old} -> {plan[i]['start_s']}")


def _mut_swap_kind(scenario: dict, rng: random.Random) -> Optional[str]:
    """Swap one windowed rule to a different windowed kind."""
    plan = scenario["faultPlan"]
    idx = _windowed_rules(plan)
    if not idx:
        return None
    i = rng.choice(idx)
    old = plan[i].get("kind")
    choices = sorted(WINDOWED_KINDS - {old})
    new = rng.choice(choices)
    plan[i]["kind"] = new
    for field_name, default in _KIND_DEFAULTS.get(new, {}).items():
        plan[i].setdefault(field_name, default)
    return f"swap_kind[{i}] {old} -> {new}"


def _mut_swap_mode(scenario: dict, rng: random.Random) -> Optional[str]:
    """Flip a partition/flap's asymmetry (all|writes|reads)."""
    plan = scenario["faultPlan"]
    idx = [i for i in _windowed_rules(plan)
           if plan[i].get("kind") in ("partition", "flap")]
    if not idx:
        return None
    i = rng.choice(idx)
    old = plan[i].get("mode", "all")
    new = rng.choice([m for m in MODES if m != old])
    plan[i]["mode"] = new
    return f"swap_mode[{i}] {old} -> {new}"


def _mut_stretch_window(scenario: dict, rng: random.Random) -> Optional[str]:
    """Scale one window's length (0 = open-ended stays open-ended)."""
    plan = scenario["faultPlan"]
    idx = [i for i in _windowed_rules(plan)
           if float(plan[i].get("window_s", 0.0) or 0.0) > 0.0]
    if not idx:
        return None
    i = rng.choice(idx)
    factor = round(rng.uniform(1.0 / MAX_WINDOW_SCALE, MAX_WINDOW_SCALE), 2)
    old = float(plan[i]["window_s"])
    plan[i]["window_s"] = round(max(old * factor, 0.5), 2)
    return f"stretch_window[{i}] window_s {old} -> {plan[i]['window_s']}"


def _mut_scale_jobs(scenario: dict, rng: random.Random) -> Optional[str]:
    """Scale the replay job count (clamped to the fuzz bounds)."""
    profile = scenario["profile"]
    factor = rng.choice((0.5, 1.5, 2.0))
    old = int(profile.get("jobs", REPLAY_JOB_FLOOR) or REPLAY_JOB_FLOOR)
    profile["jobs"] = int(min(max(round(old * factor), FUZZ_JOB_FLOOR),
                              FUZZ_JOB_CAP))
    return f"scale_jobs x{factor} {old} -> {profile['jobs']}"


def _mut_jitter_rate(scenario: dict, rng: random.Random) -> Optional[str]:
    """Scale the publish rate — same jobs, different arrival pressure."""
    profile = scenario["profile"]
    factor = round(rng.uniform(0.5, 2.0), 2)
    old = float(profile.get("publish_rate", 2.5) or 2.5)
    profile["publish_rate"] = round(
        min(max(old * factor, MIN_RATE), MAX_RATE), 2)
    return f"jitter_rate x{factor} {old} -> {profile['publish_rate']}"


#: the mutation menu, in a FIXED order (determinism: rng.choice over a
#: stable tuple, never over set iteration)
MUTATIONS = (
    _mut_shift_window,
    _mut_swap_kind,
    _mut_swap_mode,
    _mut_stretch_window,
    _mut_scale_jobs,
    _mut_jitter_rate,
)


def mutate_scenario(scenario: dict, rng: random.Random,
                    mutations: int = 2) -> Tuple[dict, List[str]]:
    """Apply ``mutations`` seeded mutations to a DEEP COPY of the
    scenario; returns (variant, human-readable mutation log).  A
    mutation that does not apply (e.g. no windowed rules to shift)
    draws again, bounded, so sparse plans still fuzz."""
    variant = copy.deepcopy(scenario)
    applied: List[str] = []
    attempts = 0
    while len(applied) < mutations and attempts < mutations * 8:
        attempts += 1
        note = rng.choice(MUTATIONS)(variant, rng)
        if note is not None:
            applied.append(note)
    # the profile carries the plan as env-var JSON (SoakProfile
    # contract): re-serialize so the mutated windows actually install
    variant["profile"]["fault_plan"] = scenario_fault_plan_json(variant)
    return variant, applied


def fuzz_scenarios(scenario: dict, *, seed: int = 0,
                   variants: int = 8,
                   mutations_per_variant: int = 2) -> List[dict]:
    """Breed ``variants`` deterministic mutants of one scenario.

    Each entry: ``{"name", "seed", "mutations": [...], "scenario"}``.
    One master ``Random(seed)`` drives the whole campaign, so variant
    N depends only on (scenario, seed, N) — re-running a campaign with
    the same seed reproduces every variant, and any single variant can
    be re-bred by replaying the campaign up to its index.
    """
    rng = random.Random(seed)
    out: List[dict] = []
    for i in range(max(int(variants), 0)):
        variant, applied = mutate_scenario(
            scenario, rng, mutations=mutations_per_variant)
        out.append({
            "name": f"fz-{seed}-{i:03d}",
            "seed": seed,
            "mutations": applied,
            "scenario": variant,
        })
    return out


async def _replay_variant(entry: dict, root: str) -> dict:
    """Run one variant on a fresh SoakRig fleet of the port's workers and
    return its breach signature (imports the port's test-side world
    builder, ``tests/test_torch_soak.py`` — the fuzzer is tooling, not a
    production path; the reference's ``test_soak`` would run the JAX
    package's workers)."""
    import os
    import sys

    tests_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    from test_torch_soak import SoakTestWorld

    from .compiler import scenario_profile
    from .replay import signature_from_incidents

    profile = scenario_profile(entry["scenario"])
    world = await SoakTestWorld.create(root, profile)
    try:
        report = await world.rig.run(world.workload)
        signature = signature_from_incidents(world.rig.incidents)
    finally:
        await world.close()
    return {
        "name": entry["name"],
        "mutations": entry["mutations"],
        "signature": signature,
        "guards_ok": bool(report.ok),
    }


async def run_campaign(scenario: dict, *, seed: int, variants: int,
                       execute: bool, log=print) -> dict:
    """The `make fuzz-scenarios` entry: breed variants, optionally
    replay each, and report any signature the original never had."""
    import tempfile

    from .replay import diff_signatures

    bred = fuzz_scenarios(scenario, seed=seed, variants=variants)
    original_sig = scenario.get("signature") or {}
    results: List[dict] = []
    novel: List[dict] = []
    for entry in bred:
        log(f"[fuzz] {entry['name']}: " + "; ".join(entry["mutations"]))
        if not execute:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            result = await _replay_variant(entry, tmp)
        verdict = diff_signatures(original_sig, result["signature"])
        result["novel"] = not verdict["match"]
        results.append(result)
        if result["novel"]:
            novel.append(result)
            log(f"[fuzz] {entry['name']}: NEW breach signature "
                f"{json.dumps(result['signature'], sort_keys=True)}")
        else:
            log(f"[fuzz] {entry['name']}: signature unchanged")
    return {
        "seed": seed,
        "variants": [e["name"] for e in bred],
        "executed": len(results),
        "novelSignatures": novel,
        "campaign": results if execute else [
            {"name": e["name"], "mutations": e["mutations"]} for e in bred],
    }


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m downloader_tpu_torch.incident.fuzz`` — see Makefile
    ``fuzz-scenarios`` (opt-in; deliberately not wired into CI)."""
    import argparse
    import asyncio
    import os
    import sys

    from .compiler import compile_bundle

    default_bundle = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "tests", "fixtures", "incident_bundle_v1.json")
    parser = argparse.ArgumentParser(
        description="seeded incident-scenario fuzzer (not a CI job)")
    parser.add_argument("--bundle", default=default_bundle,
                        help="incident bundle JSON to compile and fuzz")
    parser.add_argument("--seed", type=int, default=1818)
    parser.add_argument("--variants", type=int, default=6)
    parser.add_argument("--execute", action="store_true",
                        help="actually replay each variant on a SoakRig "
                             "fleet (minutes per variant)")
    args = parser.parse_args(argv)

    with open(args.bundle, encoding="utf-8") as fh:
        bundle = json.load(fh)
    scenario = compile_bundle(bundle)
    summary = asyncio.run(run_campaign(
        scenario, seed=args.seed, variants=args.variants,
        execute=args.execute))
    sys.stdout.write(json.dumps({k: v for k, v in summary.items()
                                 if k != "campaign"}, sort_keys=True) + "\n")
    return 1 if summary["novelSignatures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

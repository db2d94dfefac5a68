#!/usr/bin/env python3
"""Run chip_smoke.py's multi-rank phases alone, on a card per rank.

Run from the root of a checkout on a machine with four CUDA cards:
    python3 tools/cross_card_phases.py [PHASE ...]

Drives the context-parallel LM ring (``chip_smoke.run_ring``: 4 ranks,
B 1 x L 16384) and the VGG parts (``chip_smoke.run_vgg``: world 1, 2 and
4) with their own gates: launch counts, ranks bit for bit equal, one step
kernel path vs plain path, losses.  Then the real commands, one process
per rank: ``cli.lm --parallel ring`` at world 2
(``chip_smoke.run_ring_cli``), ``cli.part3 --ring-compress int8`` at world
2 (``chip_smoke.run_vgg_cli``) and ``cli.lm --parallel dp``, ``ring``,
``ulysses``, ``fsdp --overlap-update``, ``fsdp_pl`` (flash), ``tp``, ``pp``
(1F1B) and ``3d --dp 1 --pp 2 --tp 2`` with ``--num-nodes 4`` at the LM's
full width (``run_lm_cli`` below); each must exit 0 on every rank,
print the reference's protocol lines and name nccl in its banner.  The
serving fleet's run (a) (``run_fleet`` below): ``chip_smoke.serve_fleet``'s
steady run with replica r's engine and models on ``cuda:r``.  With a card
per rank the ranks choose nccl (``runtime/distributed.plan_placement``);
on one card they share it over gloo, as ``chip_smoke.py`` runs them.
Prints each kernel's launches over the spawned phases (the codec's by
chunk length and residual); exits 1 if a phase fails.  PHASE names limit
the run to those phases (``ring``, ``vgg``, ``ring cli``, ``vgg cli``,
``dp cli``, ``ring w4 cli``, ``ulysses cli``, ``fsdp cli``, ``fsdp_pl cli``,
``tp cli``, ``pp cli``, ``3d cli``, ``fleet``),
e.g. the VGG ones alone after a change to the int8 ring codec.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# cli.lm across LM_CLI[parallel]["world"] processes at the LM's full width
# (chip_smoke.MODEL): dp splits B 8 x L 4096 over the ranks; ring and
# ulysses split L 16384 of B 1 (the ring cell's shape; Ulysses runs K1-K3
# over the full sequence on 4 of the 16 heads a rank); fsdp splits B 4 x L 2048 with --overlap-update
# (dense attention, one K7 launch a step on each rank's flat shard);
# fsdp_pl the same batch with flash attention (every leaf split 1/4 and
# gathered at its use, one K7 launch a leaf a step); tp its heads of B 2 x L
# 2048 (4 of 16 heads, 1 of 4 KV heads a rank; flash); pp 1F1B over 4 stages
# of 2 layers, B 4 x L 2048 in 4 microbatches (explicit flash); 3d dp 1 x pp
# 2 x tp 2, B 4 x L 2048 in 2 microbatches (explicit flash).
LM_CLI = {"dp": dict(world=4, seq_len=4096, batch_size=8, max_iters=5, attn="flash"),
          "ring": dict(world=4, seq_len=16384, batch_size=1, max_iters=5, attn="flash",
                       want_attn="ring_flash"),
          "ulysses": dict(world=4, seq_len=16384, batch_size=1, max_iters=5, attn="flash",
                          want_attn="ulysses"),
          "fsdp": dict(world=4, seq_len=2048, batch_size=4, max_iters=5, attn="auto",
                       want_attn="dense", extra=("--overlap-update",)),
          "fsdp_pl": dict(world=4, seq_len=2048, batch_size=4, max_iters=5, attn="flash"),
          "tp": dict(world=4, seq_len=2048, batch_size=2, max_iters=5, attn="flash"),
          "pp": dict(world=4, seq_len=2048, batch_size=4, max_iters=5, attn="flash",
                     extra=("--pp-schedule", "1f1b", "--microbatches", "4")),
          "3d": dict(world=4, seq_len=2048, batch_size=4, max_iters=5, attn="flash",
                     extra=("--dp", "1", "--pp", "2", "--tp", "2", "--microbatches", "2"))}


def run_lm_cli(smoke, backend: str, parallel: str = "dp") -> None:
    """``python -m ...cli.lm --parallel PARALLEL --num-nodes W --master-ip
    --rank`` in W processes; every process exits 0, and rank 0's banner
    names the world, the attention and ``backend``, followed by the
    reference's timing lines."""
    cfg = LM_CLI[parallel]
    with socket.socket() as sock:  # a free port for the rendezvous
        sock.settimeout(10)
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world, m = cfg["world"], smoke.MODEL
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.lm",
           "--parallel", parallel, "--num-nodes", str(world),
           "--master-ip", f"127.0.0.1:{port}",
           "--d-model", str(m["d_model"]), "--n-layers", str(m["n_layers"]),
           "--n-heads", str(m["n_heads"]), "--n-kv-heads", str(m["n_kv_heads"]),
           "--vocab", str(m["vocab_size"]), "--seq-len", str(cfg["seq_len"]),
           "--batch-size", str(cfg["batch_size"]), "--max-iters", str(cfg["max_iters"]),
           "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--fused-update",
           "--attn", cfg["attn"], *cfg.get("extra", ())]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith(("lm parallel=", "Total execution", "Average execution",
                               "Iteration time", "Param gather"))]
    smoke.log(f"cli.lm --parallel {parallel}, {world} processes "
              f"({time.perf_counter() - t0:.1f} s): exit codes {rcs}; rank 0: {lines}")
    want = (f"lm parallel={parallel} devices={world}", "Total execution time is",
            "Average execution time is")
    attn = cfg.get("want_attn", cfg["attn"])
    if rcs != [0] * world or not all(any(ln.startswith(w) for ln in lines) for w in want) \
            or f"attn={attn}" not in lines[0] or f"backend={backend}" not in lines[0]:
        raise AssertionError(f"cli.lm {parallel}: exit codes {rcs}; output tails "
                             f"{[o[-2000:] for o in outs]}")


def run_fleet(smoke, torch, card: str) -> None:
    """``chip_smoke.fleet_run``'s run (a) with a card per replica: the LM at
    full width (bf16, the seed's weights) copied to ``cuda:r`` for replica
    r with its own int8 twin and pool; 2 live and 1 spare, FLEET_REQUESTS
    requests, the latency lever.  Gates: exactly once with no eviction,
    every request well formed, first tokens against the plain path, K1 and
    K5 launched.
    Reports tokens/s beside one engine's drain of the same requests on
    ``cuda:0``."""
    import copy

    import distributed_machine_learning_tpu_torch as pkg
    from distributed_machine_learning_tpu_torch.ops import build

    world = smoke.FLEET["replicas"] + smoke.FLEET["spares"]
    models, _ = smoke.make_models(torch, pkg)
    base = models.pop("bf16")
    del models
    engines = []
    for r in range(world):
        model = base if r == 0 else copy.deepcopy(base).to(f"cuda:{r}")
        with torch.cuda.device(r):
            engines += smoke.fleet_engines(torch, model, 1)
    prompts, news = smoke.engine_traffic(torch, smoke.FLEET_REQUESTS)
    lone, seconds = smoke.drain_engine(torch, engines[0], prompts, news)
    smoke.log(f"fleet, a card per replica: one engine's drain of the same requests on "
              f"cuda:0 [{card}]: {seconds:.3f} s -> {sum(news) / seconds:.1f} generated tok/s")
    build.reset_launch_counts()
    a = smoke.fleet_run(torch, engines, prompts, news)
    launches = dict(build.launches)
    smoke.log_fleet_run("a, a card per replica", a, news, card)
    smoke.log(f"fleet run (a), a card per replica: launches {launches}")
    v = a["verdict"]
    if not (v["exactly_once"] and v["admitted"] == v["completed"] == smoke.FLEET_REQUESTS
            and v["evictions"] == 0):
        raise AssertionError(f"fleet, a card per replica: not exactly once, or an eviction: {v}")
    for name in ("flash_fwd", "paged_attention"):
        if launches[name] == 0:
            raise AssertionError(f"fleet, a card per replica: {name} never launched")
    smoke.check_completions(a["done"], prompts, news, "fleet, a card per replica")
    same = sum(a["done"][i]["tokens"] == lone[i]["tokens"] for i in range(len(prompts)))
    smoke.log(f"fleet, a card per replica vs the lone engine: {same}/{len(prompts)} "
              f"requests equal token for token")
    smoke.check_first_tokens(torch, engines[0], a["done"], prompts,
                             "fleet, a card per replica")


if __name__ == "__main__":  # the phases spawn ranks that import this module
    import torch

    import chip_smoke as smoke
    from distributed_machine_learning_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("cross_card_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    cards = torch.cuda.device_count()
    card = smoke.card_line()
    print(f"card: {card}; {cards} cards", flush=True)
    build.build_all()
    rows = {name: {} for name in build.KERNELS}
    rows.update({smoke.codec_row(k, n, r): {} for k in smoke.CODEC_KERNELS
                 for n in smoke.CODEC_PATH_LENGTHS for r in (True, False)
                 if r or k == "ring_encode_int8"})  # the codec's launches by row
    rows.update({smoke.codec_row("ring_decode_int8", n, rows=w): {}
                 for w, n in smoke.CODEC_ALLGATHER})  # the all-gather's batched K10
    backend = "nccl" if cards >= LM_CLI["dp"]["world"] else "gloo"
    phases = [("ring", lambda: smoke.run_ring(torch, rows)),
              ("vgg", lambda: smoke.run_vgg(torch, rows)),
              ("ring cli", lambda: smoke.run_ring_cli(torch, backend)),
              ("vgg cli", lambda: smoke.run_vgg_cli(torch, backend)),
              ("dp cli", lambda: run_lm_cli(smoke, backend, "dp")),
              ("ring w4 cli", lambda: run_lm_cli(smoke, backend, "ring")),
              ("ulysses cli", lambda: run_lm_cli(smoke, backend, "ulysses")),
              ("fsdp cli", lambda: run_lm_cli(smoke, backend, "fsdp")),
              ("fsdp_pl cli", lambda: run_lm_cli(smoke, backend, "fsdp_pl")),
              ("tp cli", lambda: run_lm_cli(smoke, backend, "tp")),
              ("pp cli", lambda: run_lm_cli(smoke, backend, "pp")),
              ("3d cli", lambda: run_lm_cli(smoke, backend, "3d")),
              ("fleet", lambda: run_fleet(smoke, torch, card))]
    chosen = sys.argv[1:] or [name for name, _ in phases]
    unknown = set(chosen) - {name for name, _ in phases}
    if unknown:
        print(f"cross_card_phases: unknown phases {sorted(unknown)}", file=sys.stderr)
        sys.exit(2)
    phases = [(name, phase) for name, phase in phases if name in chosen]
    failed = []
    for name, phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except AssertionError as exc:
            failed.append(f"{name}: {exc}")
        print(f"{name} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    print({name: (row.get("ring_launches"), row.get("vgg_launches"))
           for name, row in rows.items()}, flush=True)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        sys.exit(1)

"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Drives a continuous-batching :class:`~repro_torch.train.ServeSession`
(after ``repro.launch.serve``): more requests than ``--slots`` exercises
mid-flight slot reuse. Reports the per-outcome counts of
``session.stats()`` and exits non-zero if any request ``FAILED``. With
``--paged`` the report adds the page arena's counters (give it
``--shared-prefix N --prefill-chunk C`` so there is a system prompt to
share); ``--quantize int8`` serves the DS table from int8 rows under the
exactness gate and prints its report (exits non-zero when unguarded id
flips survive the fallback); ``--adapt`` runs the online repack; ``--draft
<arch> --gamma G`` turns on exact speculative decoding and the report adds
the tokens per verify step and the acceptance rate. The token-only
families serve: dense, moe, vlm (token prompts), and the ssm and hybrid
state families. An encdec arch raises ``ServeSession``'s ``ValueError``
(its requests need encoder frames), as in ``repro``; so does an encdec
``--draft``.

Runs on CUDA unless given ``--device cpu``; ``--reduced`` takes the small
config of the same family (the draft's too). Weights are seeded (target 0,
draft 1).

``--mesh DxM`` serves expert-parallel over one process per rank, started by
``torchrun --nproc-per-node N`` (N = D·M): every rank builds the same
seeded model and drives the same requests, and prints the same report
but for one line: the cache bytes the rank holds (its block of the slots
where the mesh's data ranks divide ``--slots``) beside the whole cache's.
``--param-mode fsdp`` (requires ``--mesh``) stores the weights split over
the mesh's ``data`` axis. On CUDA each rank takes one card; wider worlds
run on the CPU (``--device cpu``, ``gloo``). ``--dist-store PATH`` joins the
ranks through a file store instead of ``torchrun``'s TCP rendezvous.
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import build
from repro_torch.serve.table_manager import AdaptPolicy
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

def main(argv=None) -> ServeSession:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="small config of the same family")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=8, help="number of requests")
    ap.add_argument("--slots", type=int, default=4, help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--kernel", default=None,
                    help="serve kernel or policy name (default: the config's 'auto')")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill into slots, in chunks of this many tokens")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="expert-parallel serving mesh (DxM or PxDxM) over the torchrun "
                         "world: tokens over data, the DS table's experts over model")
    ap.add_argument("--param-mode", default="replicated", choices=("replicated", "fsdp"),
                    help="fsdp (requires --mesh): store the weights split over the mesh's "
                         "data axis and gather each layer where it runs")
    ap.add_argument("--dist-store", default=None, metavar="PATH",
                    help="file store the ranks join through (default: torchrun's env)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the admission queue: overflow sheds the lowest-priority, "
                         "newest request (REJECTED)")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request deadline in steps: requests still queued or decoding "
                         "past it end TIMED_OUT")
    ap.add_argument("--paged", action="store_true",
                    help="fixed-size-page KV arena with copy-on-write prefix sharing and "
                         "priority preemption")
    ap.add_argument("--page-size", type=int, default=16, help="positions per page")
    ap.add_argument("--page-arena", type=int, default=None,
                    help="allocatable pages (default: the contiguous cache's capacity)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable copy-on-write prefix sharing")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens to every request")
    ap.add_argument("--adapt", action="store_true",
                    help="traffic-adaptive serving: repack the DS table to the observed "
                         "traffic when the window's overflow rate exceeds "
                         "--adapt-overflow-threshold, and hot-swap it between steps")
    ap.add_argument("--adapt-interval", type=int, default=32,
                    help="steps between adaptation checks")
    ap.add_argument("--adapt-overflow-threshold", type=float, default=0.05,
                    help="window overflow rate that triggers a repack")
    ap.add_argument("--adapt-prune-gamma", type=float, default=None,
                    help="group-lasso threshold of the repack's re-prune (default: none)")
    ap.add_argument("--adapt-max-swaps", type=int, default=4, help="cap on hot-swaps")
    ap.add_argument("--stats-window", type=int, default=128,
                    help="steps in the per-expert stats window the adaptation reads")
    ap.add_argument("--quantize", default=None, choices=("int8",),
                    help="serve the DS table from int8 rows under the exactness gate")
    ap.add_argument("--quantize-calib", type=int, default=256,
                    help="calibration activations drawn for the exactness gate")
    ap.add_argument("--quantize-flip-threshold", type=float, default=0.0,
                    help="per-expert flip-rate bound before fp fallback")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    help="speculative decoding: a token-only config (reduced with "
                         "--reduced, and put on the target's vocab) proposes --gamma tokens "
                         "per slot per step, verified by the target in one chunk-shaped step")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft tokens proposed per slot per speculative step")
    args = ap.parse_args(argv)
    if args.param_mode == "fsdp" and not args.mesh:
        ap.error("--param-mode fsdp requires --mesh")
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh

        mesh = parse_mesh(args.mesh, device=args.device, store=args.dist_store)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    bundle = build(cfg, device=args.device)
    params, ds_state = bundle.init(torch.Generator(device=bundle.device).manual_seed(0))
    smax = args.prompt_len + args.new_tokens
    if args.prefill_chunk:
        # tail chunks write a whole chunk of (masked) rows into the cache
        smax = max(smax, -(-args.prompt_len // args.prefill_chunk) * args.prefill_chunk)
    draft = None
    if args.draft:
        dcfg = get_config(args.draft)
        if args.reduced:
            dcfg = reduce_config(dcfg)
        # token ids must line up: the draft's head takes the target's vocab
        dcfg = dcfg.replace(vocab_size=cfg.vocab_size)
        dbundle = build(dcfg, device=args.device)
        draft = (dbundle, *dbundle.init(torch.Generator(device=dbundle.device).manual_seed(1)))
        smax += args.gamma  # a verify block writes gamma rows past the tip
    if args.paged:
        m = args.page_size if not args.prefill_chunk else np.lcm(args.page_size,
                                                                 args.prefill_chunk)
        smax = -(-smax // m) * m
    session = ServeSession(
        bundle, params, ds_state,
        n_slots=min(args.slots, args.batch),
        max_seq_len=smax,
        kernel=args.kernel,
        mesh=mesh,
        param_mode=args.param_mode,
        prefill_chunk=args.prefill_chunk,
        queue_limit=args.queue_limit,
        paged=args.paged,
        page_size=args.page_size,
        page_arena=args.page_arena,
        prefix_sharing=not args.no_prefix_sharing,
        stats_window=args.stats_window,
        adapt_policy=(AdaptPolicy(interval=args.adapt_interval,
                                  overflow_threshold=args.adapt_overflow_threshold,
                                  prune_gamma=args.adapt_prune_gamma,
                                  max_swaps=args.adapt_max_swaps) if args.adapt else None),
        quantize=args.quantize,
        quantize_calib=args.quantize_calib,
        quantize_flip_threshold=args.quantize_flip_threshold,
        device=args.device,
        draft=draft,
        gamma=args.gamma,
    )
    rng = np.random.RandomState(0)
    sysp = rng.randint(0, cfg.vocab_size, args.shared_prefix).astype(np.int32)
    tail_len = max(1, args.prompt_len - args.shared_prefix)
    reqs = [Request(prompt=np.concatenate([sysp, rng.randint(0, cfg.vocab_size, tail_len)
                                           .astype(np.int32)]),
                    sampling=SamplingParams(max_new_tokens=args.new_tokens,
                                            deadline_steps=args.deadline_steps,
                                            priority=int(rng.rand() < 0.25)))
            for _ in range(args.batch)]
    t0 = time.perf_counter()
    out = session.run(reqs)
    if session.device.type == "cuda":
        torch.cuda.synchronize(session.device)
    dt = time.perf_counter() - t0
    n = sum(len(r.out_tokens) for r in out)
    stats = session.stats()
    if mesh is not None:
        from repro_torch.launch.mesh import destroy

        destroy()
    print(f"{n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s; {stats['n_admitted']} admits over "
          f"{session.n_slots} slots)")
    print("outcomes: " + ", ".join(
        f"{k.removeprefix('n_')}={stats[k]}"
        for k in ("n_completed", "n_rejected", "n_cancelled", "n_timed_out", "n_failed",
                  "n_shed")))
    if mesh is not None:
        here, whole = session.cache_bytes()
        blk = session.local_slots
        print(f"cache on this rank: {here / 1e6:.2f} MB of the whole {whole / 1e6:.2f} MB "
              f"(slots [{blk.offset}, {blk.offset + blk.count}) of {session.n_slots}"
              f"{'' if blk.splits else ', whole'})")
    if args.paged:
        pg = stats["paged"]
        print(f"paged arena: {pg['pages_in_use']}/{pg['pages_total']} pages in use "
              f"(page_size={pg['page_size']}), cow_copies={pg['cow_copies']}, "
              f"preemptions={pg['preemptions']}")
        print(f"prefix sharing: hit_rate={pg['prefix_hit_rate']:.2f} "
              f"({pg['prefix_hits']}/{pg['prefix_queries']}), "
              f"tokens_reused={pg['prefix_tokens_reused']}, "
              f"prefill_chunks={pg['prefill_chunks']} (saved {pg['prefill_chunks_saved']})")
    if args.adapt:
        print(f"adaptive table: version={stats['table_version']} swaps={stats['n_swaps']} "
              f"decode_builds={stats['decode_builds']}, window overflow="
              f"{stats['overflow_rate_window']:.3f} over {stats['window_steps']} steps, "
              f"effective capacity_factor={stats['effective_capacity_factor']}")
    if args.draft:
        sp = stats["speculative"]
        print(f"speculative (gamma={sp['gamma']}): {sp['emitted_per_step']:.2f} tokens/step "
              f"({sp['accepted_per_step']:.2f} draft-accepted/step, "
              f"accept_rate={sp['accept_rate']:.2f}) over {sp['spec_steps']} verify steps; "
              f"graphs: draft {stats['draft_graphs']}, verify {stats['verify_graphs']}")
    if args.quantize:
        rep = stats["quantize_report"]
        print(f"quantized serving ({stats['quantize']}): exactness gate "
              f"{'PASSED' if rep['passed'] else 'FAILED'}: {rep['n_flips_raw']}/"
              f"{rep['n_tokens']} raw id flips (rate {rep['flip_rate_raw']:.3f}), "
              f"{rep['n_fallback']} experts on fp fallback {rep['fallback_experts']}, "
              f"{rep['n_unguarded_flips']} unguarded flips (threshold "
              f"{rep['flip_threshold']})")
        if not rep["passed"]:
            print("exactness gate FAILED: unguarded id flips survive the per-expert "
                  "fallback; lower --quantize-flip-threshold or serve fp", file=sys.stderr)
            sys.exit(1)
    if stats["n_failed"]:
        for r in out:
            if r.status is RequestStatus.FAILED:
                print(f"  failed: {r.error}", file=sys.stderr)
        sys.exit(1)
    return session


if __name__ == "__main__":
    main()

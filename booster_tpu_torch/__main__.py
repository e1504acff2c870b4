"""CLI: ``python -m booster_tpu_torch [--server|--chat|--prompt ...]``.

Port of ``booster_tpu/__main__.py``: flags and config files
(``serving.config``), the model load, then a one-shot generation
(``--prompt``), the HTTP server (``--server``: warmup, then
``serving.server.serve``; SIGINT/SIGTERM stop taking jobs, drain the running
ones and exit; ``--debug`` prints a job monitor) or an interactive chat
(``--chat``).  ``--device`` (default ``cuda``) is the one flag the JAX CLI
lacks: without CUDA the run fails unless ``--device cpu`` asks for the plain
versions of the kernels.  ``--weights i8c`` without ``--allow-lossy`` is
refused with exit code 2, as in the JAX CLI.  Flags of features not ported yet (a draft model,
``--lookup-decoding``, ``--grammar-file``, Self-Extend, ``--tp``,
``--profile``, a swap directory) raise NotImplementedError; a job that asks
for one fails on its own.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys
import uuid

LOGO = r"""
 ___                  _               _____ ___  _   _
| . > ___  ___  ___ _| |_ ___  _ _   |_   _| . \| | | |
| . \/ . \/ . \<_-<  | | / ._>| '_>    | | |  _/| ' | |
|___/\___/\___//__/  |_| \___.|_|      |_| |_|  `___'
"""


def _refuse_unported(args, config) -> None:
    unported = [(args.model_draft, "--model-draft (speculative decoding)"),
                (args.lookup_decoding, "--lookup-decoding"),
                (args.grammar_file, "--grammar-file"),
                (args.se_group > 1, "--self-extend-group (Self-Extend)"),
                (args.tp > 1, "--tp (tensor parallelism)"),
                (args.profile, "--profile"),
                (config.swap, "swap (session KV save and restore)")]
    for given, what in unported:
        if given:
            raise NotImplementedError(f"{what}: not ported yet")


def main(argv=None) -> int:
    from booster_tpu_torch.serving.config import build_arg_parser, config_from_args, load_config

    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO,
                        format="%(levelname)s %(message)s")
    log = logging.getLogger("booster_tpu_torch")
    if args.log:
        log.addHandler(logging.FileHandler(args.log))

    config = None
    for candidate in ([args.config] if args.config else ["config.yaml", "config.json"]):
        if candidate and os.path.exists(candidate):
            config = load_config(candidate)
            log.info(f"config loaded from {candidate}")
            break
    if config is None or args.model:
        config = config_from_args(args)
    config.host = args.host if args.host != "localhost" or not config.host else config.host
    if args.port != 8080:
        config.port = args.port
    _refuse_unported(args, config)

    if not args.silent:
        print(LOGO, file=sys.stderr)

    model_spec = next(iter(config.models.values()), None)
    if model_spec is None or not model_spec.path:
        log.error("no model specified (use --model or a config file)")
        return 1
    if not os.path.exists(os.path.expanduser(model_spec.path)):
        log.error(f"model file not found: {model_spec.path}")
        return 1
    if not (args.prompt or args.server or args.chat):
        log.error("nothing to do: give --prompt, --server or --chat")
        return 1
    if args.weights == "i8c" and not args.allow_lossy:
        log.error("--weights i8c is LOSSY (each output row of every weight is requantized "
                  "to int8 with one scale); pass --allow-lossy to acknowledge it, or use "
                  "the exact forms --weights native|bf16|i8|auto")
        return 2

    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.sampling import SamplingParams
    from booster_tpu_torch.serving import Engine
    from booster_tpu_torch.serving.config import PodSpec
    from booster_tpu_torch.serving.scheduler import Scheduler

    pod = next(iter(config.pods.values()), PodSpec(id="default"))
    batch_hint = max(pod.count, 1) if args.server else 1
    model = load_model(os.path.expanduser(model_spec.path), device=args.device,
                       weights=args.weights, batch_hint=batch_hint)
    cfg = model.cfg
    log.info(f"arch={cfg.arch} layers={cfg.n_layers} embd={cfg.n_embd} "
             f"vocab={cfg.n_vocab} device={model.device}")
    sampling = config.samplings.get(pod.sampling, SamplingParams())
    engine = Engine(model, max_batch=max(pod.count, 1), max_seq=model_spec.context,
                    kv_quantized=args.kv_quant, decode_chunk=args.decode_chunk,
                    paged=args.paged_kv, page_size=args.page_size)

    if args.prompt and not args.server and not args.chat:
        ids = model.tokenizer.encode(args.prompt)
        result = engine.generate(ids, sampling, max_new_tokens=model_spec.predict)
        print(result.text)
        log.info(f"prompt {result.prompt_ms_per_token:.1f} ms/tok · "
                 f"generate {result.gen_ms_per_token:.1f} ms/tok · "
                 f"{result.n_generated} tokens [{result.finish_reason}]")
        return 0

    scheduler = Scheduler(engine, prompt_spec=config.prompts.get(pod.prompt),
                          default_sampling=sampling, default_max_tokens=model_spec.predict,
                          deadline_s=config.deadline)
    if args.server:
        from booster_tpu_torch.serving.server import serve

        log.info("warming up (a prefill and a decode chunk)...")
        engine.warmup()
        log.info("warmup done")

        async def monitor():
            """--debug job monitor: the job table every 2 s."""
            while True:
                await asyncio.sleep(2.0)
                h = scheduler.health()
                rows = [f"  {j.id[:8]}  {j.status:<10} in:{j.n_prompt_tokens:<5} "
                        f"out:{j.n_generated:<5} {j.finish_reason or '-'}"
                        for j in list(scheduler.jobs.values())[-16:]]
                sys.stderr.write(f"[monitor] slots {h['slots_busy']}/{h['slots_total']} "
                                 f"queued {h['jobs_queued']} tok/s {h['tokens_per_sec']} "
                                 f"ttft_p50 {h['ttft_p50_ms']}ms\n" + "\n".join(rows)
                                 + ("\n" if rows else ""))

        async def run_server():
            listener = await serve(scheduler, config, model_name=model_spec.name or "default",
                                   host=config.host, port=config.port)
            mon = asyncio.get_running_loop().create_task(monitor()) if args.debug else None
            log.info(f"listening on http://{config.host}:{listener.port}")
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            await stop.wait()
            log.info("shutting down (draining jobs)...")
            await scheduler.shutdown(drain=True)
            await listener.close()
            if mon is not None:
                mon.cancel()

        asyncio.run(run_server())
        return 0

    async def chat():
        from booster_tpu_torch.utils.console import CYAN, DIM, GREEN, colorize, stream_print

        scheduler.start()
        session = str(uuid.uuid4())
        print(colorize("chat mode — empty line or Ctrl-D to exit", DIM))
        loop = asyncio.get_running_loop()
        prompt_str = colorize("\n> ", CYAN)
        while True:
            try:
                line = await loop.run_in_executor(None, input, prompt_str)
            except EOFError:
                break
            if not line.strip():
                break
            job = scheduler.place_job(prompt=line, session_id=session)
            printed = 0
            while not job._done.is_set():
                await asyncio.sleep(0.1)
                delta = job.output[printed:]
                if delta:
                    printed += len(delta)
                    stream_print(delta, GREEN)
            stream_print(job.output[printed:], GREEN)
        await scheduler.shutdown(drain=False)

    asyncio.run(chat())
    return 0


if __name__ == "__main__":
    sys.exit(main())

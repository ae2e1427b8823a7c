"""Training entry point of the port:

    python -m sparksched_tpu_torch.train -f config/decima_tpch.yaml

runs the config's trainer on the card (under the rbg stream when the
trainer block sets `fast_prng: True`, as the flagship does); `--device
cpu` runs it on the CPU (without a card and without that flag it
raises). `--resume PATH`
continues from a train state the port wrote (`<artifacts_dir>/
train_state.msgpack`) for another `num_iterations` iterations."""

from __future__ import annotations

from .config import load, make_parser
from .trainers import make_trainer


def main(argv: list[str] | None = None) -> None:
    parser = make_parser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--resume", default=None,
                        help="a train state to continue from")
    args = parser.parse_args(argv)
    trainer = make_trainer(load(args.filename), device=args.device)
    trainer.train(resume_from=args.resume)


if __name__ == "__main__":
    main()

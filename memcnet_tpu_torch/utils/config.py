"""Plain dataclass config of the demos and the trainer (the fields of
memcnet_tpu/utils/config.py that the port reads, with the same names,
defaults and coercions) — replaces the reference's my_args.py argparse module
with import-time side effects (my_args.py:76-122).  The trainer's fields
(``TRAINER_FIELDS``: learning rate, Charbonnier epsilon, loss weights) are
read by ``train.trainer.build_interp_trainer``.  The JAX fields that nothing
in the port reads (dataset, batch size, task parameter, run directory,
epochs: ``JAX_ONLY_FIELDS``) are not carried; ``add_config_args`` still
accepts a flag for each, as the JAX demos do, and ``config_from_args`` drops
it, so a command line written for a JAX demo runs the port's.  Without
``save_path``, ``Config.make_run_dir`` takes the run root as an argument."""

import dataclasses
import datetime
import json
import os
import random
from typing import Optional, Sequence


@dataclasses.dataclass
class Config:
    net_name: str = "MEMC_Net"                 # my_args.py:14
    seed: int = 1
    channels: int = 3
    filter_size: int = 4                       # :34
    task: Optional[str] = None                 # sr | denoise | deblock (:38)
    save_which: int = 1                        # 0=interp, 1=rectified (:43)
    pretrained: Optional[str] = None           # a .pth file or an io.checkpoint file (:61)
    uid: Optional[str] = None
    dtype: str = "float32"                     # float32 | bfloat16
    # trainer (documented upstream hyperparameters, my_args.py:41-59)
    lr: float = 2e-3
    epsilon: float = 1e-6
    alpha: Sequence[float] = (1.0, 0.0)

    def make_run_dir(self, root, rng=None):
        """Make ``<root>/<uid>-<%a-%b-%d-%H:%M>`` (``exist_ok``) holding
        ``args.txt``, this config as indented JSON, and return its path, as
        the JAX ``Config.make_run_dir`` does under its ``save_path``.  The
        uid is ``self.uid`` or else a random integer in [0, 100000] drawn
        from ``rng`` (a ``random.Random``; a fresh one when None)."""
        rng = rng if rng is not None else random.Random()
        uid = self.uid or str(rng.randint(0, 100000))
        stamp = datetime.datetime.now().strftime("%a-%b-%d-%H:%M")
        run_dir = os.path.join(root, f"{uid}-{stamp}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "args.txt"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)
        return run_dir


TRAINER_FIELDS = ("lr", "epsilon", "alpha")
# memcnet_tpu/utils/config.py's fields that the port does not carry
JAX_ONLY_FIELDS = ("dataset_name", "dataset_path", "batch_size", "task_param", "save_path",
                   "num_epoch")

_COERCERS = {
    "int": int,
    "float": float,
    "str": str,
    "Optional[str]": str,
    # comma-separated command-line form, e.g. 1.0,0.0
    "Sequence[float]": lambda v: v if isinstance(v, (tuple, list))
    else tuple(float(x) for x in str(v).split(",") if x != ""),
}


def _type_key(t):
    """Normalize a dataclass field annotation (object or string form) to the
    _COERCERS key."""
    if isinstance(t, str):
        return t.replace("typing.", "")
    if getattr(t, "__origin__", None) is None and hasattr(t, "__name__"):
        return t.__name__  # plain classes: int, str
    return str(t).replace("typing.", "")  # typing generics keep their args


def _coerce(field, value):
    ty = _COERCERS.get(_type_key(field.type))
    if ty is None:
        raise TypeError(
            f"Config field {field.name!r} has unhandled type {field.type!r}; "
            "add a coercer to utils.config._COERCERS"
        )
    return ty(value)


def add_config_args(parser):
    """The demos' flags: one per field of Config and of JAX_ONLY_FIELDS, the
    JAX ``add_config_args``'s set; a demo ignores those it does not read."""
    for name in [f.name for f in dataclasses.fields(Config)] + list(JAX_ONLY_FIELDS):
        parser.add_argument("--" + name.replace("_", "-"), default=None)
    return parser


def config_from_args(args, **overrides):
    kw = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is None:
            continue
        kw[f.name] = _coerce(f, v)
    kw.update(overrides)
    return Config(**kw)

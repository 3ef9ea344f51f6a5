"""Plain dataclass config of the demos (the serving fields of
memcnet_tpu/utils/config.py, with the same names, defaults and coercions) —
replaces the reference's my_args.py argparse module with import-time side
effects (my_args.py:76-122).  The trainer's fields (dataset, batch size,
learning rate, epochs, loss weights, run directory) come with the trainer's
port; until then the demos take no such flag."""

import dataclasses
from typing import Optional


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


_COERCERS = {
    "int": int,
    "str": str,
    "Optional[str]": str,
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
    for f in dataclasses.fields(Config):
        parser.add_argument("--" + f.name.replace("_", "-"), default=None)
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

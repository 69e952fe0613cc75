"""Configuration: a typed attribute tree, its defaults and YAML overrides.

The port's copy of `dro_sfm_tpu/utils/config.py`, so that it reads the same
``configs/*.yaml``: `ConfigNode` (merging rejects unknown keys and type
changes), the default tree, `prepare_config` (image shape and the broadcast
of the per-dataset lists) and `load_config`.

PyYAML is not a dependency of the port. `parse_yaml` reads the subset of
YAML that the configs use, with PyYAML's ``safe_load`` meaning: block
mappings nested by indentation, ``#`` comments, flow lists (``['a', 'b']``,
``[4]``, ``[[]]``), single- and double-quoted strings, and plain scalars
resolved as null, bool, int, float or string by the YAML 1.1 rules that
PyYAML applies (``(96, 128)`` stays a string for `_parse_image_shape`).
Anything outside the subset (block sequences, flow mappings, anchors, tags,
multi-line scalars, several documents) raises ``ValueError``.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple


class ConfigNode:
    """A nested attribute dictionary with type-checked merging."""

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if init:
            for k, v in init.items():
                self._data[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, key):
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self._data[key] = ConfigNode(value) if isinstance(value, dict) else value

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        setattr(self, key, value)

    def __contains__(self, key):
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, key, default=None):
        return self._data.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v
                for k, v in self._data.items()}

    def merge_dict(self, other: Dict[str, Any], path: str = "") -> "ConfigNode":
        """Deep-merge ``other`` into this node: an unknown key or a change
        of type is an error."""
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self._data:
                raise KeyError(f"Unknown config key: {full}")
            cur = self._data[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot override node {full} with a leaf")
                cur.merge_dict(v, full)
            else:
                self._data[k] = _coerce(cur, v, full)
        return self

    def __repr__(self):
        return f"ConfigNode({self.to_dict()})"


def _coerce(cur, new, path):
    if cur is None or new is None:
        return new
    # Tri-state knobs: the default is the string "auto", overridable with an
    # explicit bool (model.depth_net.remat) or string.
    if cur == "auto" or new == "auto":
        return new
    if isinstance(cur, bool) != isinstance(new, bool):
        raise TypeError(f"Type mismatch at {path}: {type(cur)} vs {type(new)}")
    if isinstance(cur, float) and isinstance(new, int):
        return float(new)
    if isinstance(cur, (tuple, list)) and isinstance(new, (tuple, list)):
        return type(cur)(new)
    # image_shape may be written as the string "(192, 640)"; prepare_config
    # parses it into a tuple.
    if isinstance(cur, str) and isinstance(new, (tuple, list)):
        return new
    if isinstance(cur, (tuple, list)) and isinstance(new, str):
        return new
    if not isinstance(new, type(cur)) and not isinstance(cur, type(new)):
        raise TypeError(f"Type mismatch at {path}: {type(cur)} vs {type(new)}")
    return new


def _dataset_section(batch_size, num_workers, back_context, forward_context):
    return {
        "batch_size": batch_size,
        "num_workers": num_workers,
        "back_context": back_context,
        "forward_context": forward_context,
        "dataset": [],
        "path": [],
        "split": [],
        "depth_type": [""],
        "cameras": [[]],
        "repeat": [1],
        "num_logs": 5,
        "strides": (1,),
    }


DEFAULTS: Dict[str, Any] = {
    "name": "",
    "debug": False,
    # spatial_shards: image heights split over this many devices per
    # data-parallel replica (`parallel/spatial.py`), for every task.
    "arch": {"seed": 42, "min_epochs": 1, "max_epochs": 50,
             "spatial_shards": 1},
    "checkpoint": {
        "filepath": "./results/model",
        "save_top_k": 5,
        "monitor": "abs_rel_pp_gt",
        "monitor_index": 0,
        "mode": "auto",
        "s3_path": "",
        "s3_frequency": 1,
        "s3_url": "",
    },
    "save": {
        "folder": "./results",
        "depth": {"rgb": True, "viz": True, "npz": True, "png": True},
        "pretrained": "",
    },
    "wandb": {
        "dry_run": True, "name": "", "project": "", "entity": "",
        "tags": [], "dir": "", "url": "",
        "num_logs": 5,
    },
    "model": {
        "name": "",
        "checkpoint_path": "",
        "optimizer": {
            "name": "Adam",
            "depth": {"lr": 0.0002, "weight_decay": 0.0},
            "pose": {"lr": 0.0002, "weight_decay": 0.0},
            "momentum": 0.9,
            "clip_grad_norm": 0.0,
        },
        "scheduler": {
            "name": "StepLR", "step_size": 10, "gamma": 0.5,
            "T_max": 20, "eta_min": 1e-7,
            "milestones": [10, 15, 20, 25, 30, 35, 40, 45],
            # Linear rate ramp over the first N optimizer steps (0 = off).
            "warmup_steps": 0,
        },
        "params": {"crop": "", "min_depth": 0.0, "max_depth": 80.0},
        "loss": {
            "num_scales": 4,
            "progressive_scaling": 0.0,
            "flip_lr_prob": 0.5,
            "rotation_mode": "euler",
            "upsample_depth_maps": True,
            "ssim_loss_weight": 0.85,
            "occ_reg_weight": 0.1,
            "smooth_loss_weight": 0.001,
            "C1": 1e-4,
            "C2": 9e-4,
            "photometric_reduce_op": "min",
            "disp_norm": True,
            "clip_loss": 0.0,
            "padding_mode": "zeros",
            "automask_loss": True,
            "velocity_loss_weight": 0.1,
            "supervised_method": "sparse-l1",
            "supervised_num_scales": 4,
            "supervised_loss_weight": 0.9,
            "percep_loss_weight": 0.0,
        },
        "depth_net": {"name": "", "checkpoint_path": "", "version": "",
                      "dropout": 0.0,
                      # bf16 convolutions (fp32 geometry), the warp sampler
                      # (K1-K3 on the card), the GRU passes, and the memory
                      # knobs, which "auto" resolves for the training batch
                      # and image size (models.sfm.resolve_memory_policy).
                      "mixed_precision": True,
                      "warp_impl": "pallas",
                      "sep_conv": "split",
                      "remat": "auto",
                      "scan_unroll": "auto",
                      "pretrained_encoders": ""},
        "pose_net": {"name": "", "checkpoint_path": "", "version": "",
                     "dropout": 0.0},
        "percep_net": {"name": "", "checkpoint_path": "", "version": "",
                       "dropout": 0.0},
    },
    "datasets": {
        "augmentation": {
            "image_shape": (192, 640),
            "jittering": (0.2, 0.2, 0.2, 0.05),
        },
        "train": _dataset_section(8, 16, 1, 1),
        "validation": _dataset_section(1, 8, 0, 0),
        "test": _dataset_section(1, 8, 0, 0),
    },
    "config": "",
    "default": "",
    "prepared": False,
}


def get_default_config() -> ConfigNode:
    return ConfigNode(copy.deepcopy(DEFAULTS))


def _parse_image_shape(value):
    if isinstance(value, str):
        value = value.strip("()[] ")
        return tuple(int(x) for x in value.split(","))
    return tuple(int(x) for x in value)


def prepare_config(cfg: ConfigNode) -> ConfigNode:
    """Post-merge fix-ups: the image shape as a tuple of ints, and each
    split's per-dataset lists broadcast to its number of datasets."""
    cfg.datasets.augmentation.image_shape = _parse_image_shape(
        cfg.datasets.augmentation.image_shape)
    for split in ("train", "validation", "test"):
        section = cfg.datasets[split]
        n = len(section.dataset)
        for key in ("path", "split", "depth_type", "cameras", "repeat"):
            val = list(section[key])
            if n == 0:
                continue
            if len(val) == 1 and n > 1:
                val = val * n
            while len(val) < n:
                val.append(val[-1] if val else "")
            section[key] = val
    return cfg


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> ConfigNode:
    """The defaults, merged with a YAML file and then with ``overrides``."""
    cfg = get_default_config()
    if yaml_path:
        with open(yaml_path) as f:
            data = parse_yaml(f.read()) or {}
        cfg.merge_dict(data)
        cfg.config = yaml_path
        if not cfg.name:
            cfg.name = os.path.splitext(os.path.basename(yaml_path))[0]
    if overrides:
        cfg.merge_dict(overrides)
    return prepare_config(cfg)


# --- the YAML subset ----------------------------------------------------------

# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader does it.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = ("yes", "true", "on")
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                        r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_OTHER_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                          r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _plain_scalar(text: str, where: str):
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _DECIMAL.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _OTHER_INT.match(text) or _OTHER_FLOAT.match(text):
        raise ValueError(f"{where}: scalar {text!r} is outside the YAML subset "
                         "this reader supports")
    if (text[0] in "&*!|>%@`{?" or text == "-" or text.startswith("- ")
            or ": " in text or text.endswith(":")):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset this "
                         "reader supports")
    return text


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Reader of one value: a flow list, a quoted string or a plain scalar."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def error(self, msg):
        return ValueError(f"{self.where}: {msg} in {self.text!r}")

    def skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def value(self, in_list: bool = False):
        self.skip()
        if self.pos >= len(self.text):
            raise self.error("missing value")
        ch = self.text[self.pos]
        if ch == "[":
            return self.flow_list()
        if ch == "'":
            return self.single_quoted()
        if ch == '"':
            return self.double_quoted()
        if ch == "{":
            raise self.error("flow mappings are outside the supported subset")
        end = self.pos
        stops = ",]" if in_list else ""
        while end < len(self.text) and self.text[end] not in stops:
            end += 1
        token = self.text[self.pos:end].strip()
        self.pos = end
        return _plain_scalar(token, self.where)

    def flow_list(self) -> List[Any]:
        self.pos += 1
        out: List[Any] = []
        while True:
            self.skip()
            if self.pos >= len(self.text):
                raise self.error("unclosed '['")
            if self.text[self.pos] == "]":
                self.pos += 1
                return out
            out.append(self.value(in_list=True))
            self.skip()
            if self.pos < len(self.text) and self.text[self.pos] == ",":
                self.pos += 1
            elif self.pos >= len(self.text) or self.text[self.pos] != "]":
                raise self.error("expected ',' or ']'")

    def single_quoted(self) -> str:
        out, i = [], self.pos + 1
        while i < len(self.text):
            if self.text[i] == "'":
                if self.text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return "".join(out)
            out.append(self.text[i])
            i += 1
        raise self.error("unclosed single quote")

    def double_quoted(self) -> str:
        escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0"}
        out, i = [], self.pos + 1
        while i < len(self.text):
            ch = self.text[i]
            if ch == "\\":
                nxt = self.text[i + 1:i + 2]
                if nxt not in escapes:
                    raise self.error(f"escape \\{nxt} is outside the supported subset")
                out.append(escapes[nxt])
                i += 2
                continue
            if ch == '"':
                self.pos = i + 1
                return "".join(out)
            out.append(ch)
            i += 1
        raise self.error("unclosed double quote")

    def done(self):
        self.skip()
        if self.pos != len(self.text):
            raise self.error("unexpected text after the value")


def _read_value(text: str, where: str):
    reader = _Flow(text, where)
    value = reader.value()
    reader.done()
    return value


def parse_yaml(text: str) -> Optional[Dict[str, Any]]:
    """``yaml.safe_load`` for the subset of YAML that ``configs/*.yaml``
    use (see the module docstring); None for an empty document."""
    lines: List[Tuple[int, int, str]] = []        # (line number, indent, content)
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {no}: tabs in indentation")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.strip() in ("---", "..."):
            raise ValueError(f"line {no}: document markers are outside the "
                             "supported subset")
        lines.append((no, len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    root, pos = _block_mapping(lines, 0, lines[0][1])
    if pos != len(lines):
        raise ValueError(f"line {lines[pos][0]}: indentation does not match "
                         "any enclosing mapping")
    return root


def _split_key(content: str, where: str) -> Tuple[str, str]:
    """``key: rest`` -> (key, rest). The key is a plain or quoted scalar."""
    if content[0] in "'\"":
        reader = _Flow(content, where)
        key = reader.value()
        rest = content[reader.pos:]
        if not rest.startswith(":"):
            raise ValueError(f"{where}: expected ':' after the key")
        return key, rest[1:]
    m = re.match(r"^([^:#\[\]{},]+?)\s*:(?:\s+|$)", content)
    if not m:
        if content.startswith("- ") or content == "-":
            raise ValueError(f"{where}: block sequences are outside the "
                             "supported subset")
        raise ValueError(f"{where}: expected 'key: value', got {content!r}")
    return m.group(1), content[m.end():]


def _block_mapping(lines, pos: int, indent: int):
    out: Dict[str, Any] = {}
    while pos < len(lines):
        no, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {no}: unexpected indentation")
        where = f"line {no}"
        key, rest = _split_key(content, where)
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        pos += 1
        if rest.strip():
            out[key] = _read_value(rest.strip(), where)
        elif pos < len(lines) and lines[pos][1] > indent:
            out[key], pos = _block_mapping(lines, pos, lines[pos][1])
        else:
            out[key] = None
    return out, pos

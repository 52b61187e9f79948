"""INI-compatible configuration system.

Drop-in parity with the reference config schema (reference:
``configs/README.md``, parsing in ``pretrain_mim.py:40-41`` and
``train_predictor.py:37-38``): sections ``[DATA]``, ``[TRAINING]``,
``[ARCHITECTURE]``, ``[Notes]``; both ``key = value`` and ``key: value``
syntaxes; list values written as Python literals; booleans accepted as
yes/true/t/1 (reference ``utils/misc.py:6-7``); ``total_batch_iters`` may be
written in float notation (``1000000.0``).

The reference spells the pretrained-checkpoint key ``pretained_mae`` [sic]
(``train_predictor.py:52``); we accept both that spelling and
``pretrained_mae`` so existing config files work unmodified.
"""

from __future__ import annotations

import ast
import configparser
import os
from typing import Any, Iterator, Mapping


def str2bool(value: str | bool) -> bool:
    """Reference-compatible boolean parsing (``utils/misc.py:6-7``)."""
    if isinstance(value, bool):
        return value
    return value.strip().lower() in ("yes", "true", "t", "1")


class Section(Mapping[str, str]):
    """A typed view over one INI section."""

    def __init__(self, name: str, values: dict[str, str]):
        self.name = name
        self._values = values

    # Mapping protocol -----------------------------------------------------
    def __getitem__(self, key: str) -> str:
        return self._values[key.lower()]

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and key.lower() in self._values

    # Typed accessors ------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key.lower(), default)

    def str(self, key: str, default: str | None = None) -> str:
        v = self.get(key, default)
        if v is None:
            raise KeyError(f"[{self.name}] missing key {key!r}")
        return v

    def int(self, key: str, default: int | None = None) -> int:
        v = self.get(key)
        if v is None:
            if default is None:
                raise KeyError(f"[{self.name}] missing key {key!r}")
            return default
        # int(float(...)) so values like "1000000.0" parse (ref quirk)
        return int(float(v))

    def float(self, key: str, default: float | None = None) -> float:
        v = self.get(key)
        if v is None:
            if default is None:
                raise KeyError(f"[{self.name}] missing key {key!r}")
            return default
        return float(v)

    def bool(self, key: str, default: bool | None = None) -> bool:
        v = self.get(key)
        if v is None:
            if default is None:
                raise KeyError(f"[{self.name}] missing key {key!r}")
            return default
        return str2bool(v)

    def list(self, key: str, default: list | None = None) -> list:
        """Parse a Python-literal list value (safe replacement for the
        reference's ``eval()`` of config values, ``pretrain_mim.py:89-90``)."""
        v = self.get(key)
        if v is None:
            if default is None:
                raise KeyError(f"[{self.name}] missing key {key!r}")
            return default
        parsed = ast.literal_eval(v)
        if not isinstance(parsed, (list, tuple)):
            raise ValueError(f"[{self.name}] {key} is not a list: {v!r}")
        return list(parsed)


class Config:
    """A parsed model config (one ``<model_name>.ini`` file)."""

    def __init__(self, sections: dict[str, dict[str, str]], name: str = ""):
        self.name = name
        self._sections = {k: Section(k, v) for k, v in sections.items()}

    @classmethod
    def from_file(cls, path: str) -> "Config":
        parser = configparser.ConfigParser()
        read = parser.read(path)
        if not read:
            raise FileNotFoundError(f"config file not found: {path}")
        sections = {s: dict(parser.items(s)) for s in parser.sections()}
        name = os.path.splitext(os.path.basename(path))[0]
        return cls(sections, name=name)

    @classmethod
    def from_dict(cls, d: Mapping[str, Mapping[str, Any]], name: str = "") -> "Config":
        sections = {
            str(s): {str(k).lower(): str(v) for k, v in kv.items()}
            for s, kv in d.items()
        }
        return cls(sections, name=name)

    def __getitem__(self, section: str) -> Section:
        return self._sections[section]

    def __contains__(self, section: str) -> bool:
        return section in self._sections

    def sections(self) -> list[str]:
        return list(self._sections)

    # Convenience views ----------------------------------------------------
    @property
    def data(self) -> Section:
        return self._sections["DATA"]

    @property
    def training(self) -> Section:
        return self._sections["TRAINING"]

    @property
    def architecture(self) -> Section:
        return self._sections["ARCHITECTURE"]

    def pretrained_mae_name(self) -> str | None:
        """Name of the pretraining config this predictor builds on, or None.

        Accepts both the reference's ``pretained_mae`` [sic] spelling and the
        corrected ``pretrained_mae``.
        """
        for key in ("pretained_mae", "pretrained_mae"):
            if "TRAINING" in self and key in self.training:
                v = self.training.str(key)
                return None if v == "None" else v
        return None

    def describe(self) -> str:
        lines = []
        for sname in self.sections():
            lines.append(f"  {sname}")
            for k, v in self._sections[sname].items():
                lines.append(f"    {k}: {self._sections[sname][k]}")
        return "\n".join(lines)

    def to_ini(self, path: str) -> None:
        parser = configparser.ConfigParser()
        for sname in self.sections():
            parser[sname] = dict(self._sections[sname]._values)
        with open(path, "w") as f:
            parser.write(f)


def load_config(model_name: str, config_dir: str) -> Config:
    """Load ``<config_dir>/<model_name>.ini`` (reference ``pretrain_mim.py:40-41``)."""
    return Config.from_file(os.path.join(config_dir, model_name + ".ini"))


def apply_overrides(config: Config, overrides, name: str = "") -> Config:
    """``config`` with ``SECTION.key=value`` overrides applied (the CLI
    twins' ``--set``); a section the config lacks is an error."""
    if not overrides:
        return config
    d = {sec: dict(config[sec].items()) for sec in config.sections()}
    for item in overrides:
        key, sep, value = item.partition("=")
        sec, dot, k = key.partition(".")
        if not (sep and dot and sec in d):
            raise ValueError(f"--set {item!r}: want SECTION.key=value with a section of "
                             f"the config ({sorted(d)})")
        d[sec][k] = value
    return Config.from_dict(d, name=name or config.name)

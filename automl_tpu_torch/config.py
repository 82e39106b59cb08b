"""Config system: attr-style nested dict with override-string / YAML layering.

The PyTorch counterpart of automl_tpu/config.py, which is plain Python plus
yaml: the same class, ported rather than imported because importing any
module of automl_tpu loads jax. yaml is imported where a YAML file is read
or written, so the package imports where yaml is not installed.

  * attribute-style access into arbitrarily nested dicts,
  * `update()` accepts new keys, `override()` is strict (unknown key -> KeyError),
  * override sources: another Config / dict, a "k=v,k2.k3=v" string, or a ".yaml" path,
  * scalar parsing preserves the existing value's type where possible,
  * '*' splits a value into a list ("4*2" -> [4, 2]); '|' splits into nested lists.
"""

from __future__ import annotations

import copy
from typing import Any


def parse_scalar(text: str) -> Any:
  """Parse a scalar from an override string; best-effort typing."""
  t = text.strip()
  low = t.lower()
  if low in ("none", "null"):
    return None
  if low == "true":
    return True
  if low == "false":
    return False
  try:
    return int(t)
  except ValueError:
    pass
  try:
    return float(t)
  except ValueError:
    pass
  return t


def _parse_value(text: str) -> Any:
  """Parse an override value: '|' makes nested lists, '*' makes a flat list."""
  if "|" in text:
    return [_parse_value(part) for part in text.split("|")]
  if "*" in text:
    return [parse_scalar(p) for p in text.split("*")]
  return parse_scalar(text)


def _split_toplevel_commas(s: str) -> list[str]:
  """Split on commas not inside brackets/parens (tuples-as-values survive)."""
  parts, depth, cur = [], 0, []
  for ch in s:
    if ch in "([{":
      depth += 1
    elif ch in ")]}":
      depth -= 1
    if ch == "," and depth == 0:
      parts.append("".join(cur))
      cur = []
    else:
      cur.append(ch)
  if cur:
    parts.append("".join(cur))
  return [p for p in (p.strip() for p in parts) if p]


class Config:
  """Nested attr-dict with strict `override` and permissive `update`."""

  def __init__(self, initial: dict | None = None):
    object.__setattr__(self, "_data", {})
    if initial:
      for k, v in initial.items():
        self._data[k] = Config(v) if isinstance(v, dict) else v

  # --- mapping / attribute protocol -------------------------------------
  def __getattr__(self, name: str):
    data = object.__getattribute__(self, "_data")
    if name in data:
      return data[name]
    raise AttributeError(f"Config has no key {name!r}")

  def __setattr__(self, name: str, value):
    self._data[name] = Config(value) if isinstance(value, dict) else value

  def __getitem__(self, name):
    return self._data[name]

  def __setitem__(self, name, value):
    setattr(self, name, value)

  def __contains__(self, name):
    return name in self._data

  def __iter__(self):
    return iter(self._data)

  def keys(self):
    return self._data.keys()

  def items(self):
    return self._data.items()

  def get(self, name, default=None):
    return self._data.get(name, default)

  def __eq__(self, other):
    if isinstance(other, Config):
      return self.as_dict() == other.as_dict()
    if isinstance(other, dict):
      return self.as_dict() == other
    return NotImplemented

  def __repr__(self):
    return f"Config({self.as_dict()!r})"

  def __deepcopy__(self, memo):
    return Config(copy.deepcopy(self.as_dict(), memo))

  # --- layering ----------------------------------------------------------
  def update(self, src) -> "Config":
    """Merge `src`, allowing new keys."""
    return self._merge(src, strict=False)

  def override(self, src, allow_new_keys: bool = False) -> "Config":
    """Merge `src`; unknown keys raise unless allow_new_keys."""
    return self._merge(src, strict=not allow_new_keys)

  def _merge(self, src, strict: bool) -> "Config":
    if src is None or src == "":
      return self
    if isinstance(src, str):
      if src.endswith((".yaml", ".yml")):
        import yaml  # only YAML sources need it
        with open(src) as f:
          src = yaml.safe_load(f)
      else:
        src = _parse_override_str(src)
    if isinstance(src, Config):
      src = src.as_dict()
    if not isinstance(src, dict):
      raise ValueError(f"Cannot merge {type(src)} into Config")
    self._merge_dict(src, strict)
    return self

  def _merge_dict(self, d: dict, strict: bool):
    for k, v in d.items():
      if strict and k not in self._data:
        raise KeyError(f"Unknown config key {k!r} (strict override)")
      cur = self._data.get(k)
      if isinstance(cur, Config) and isinstance(v, (dict, Config)):
        cur._merge_dict(v.as_dict() if isinstance(v, Config) else v, strict)
      else:
        if strict and cur is not None and not isinstance(cur, Config):
          v = _coerce_like(v, cur)
        self._data[k] = Config(v) if isinstance(v, dict) else v

  # --- (de)serialization ---------------------------------------------------
  def as_dict(self) -> dict:
    out = {}
    for k, v in self._data.items():
      out[k] = v.as_dict() if isinstance(v, Config) else copy.deepcopy(v)
    return out

  def to_yaml(self) -> str:
    import yaml
    return yaml.safe_dump(self.as_dict(), default_flow_style=False)

  def save_to_yaml(self, path: str):
    with open(path, "w") as f:
      f.write(self.to_yaml())

  @classmethod
  def from_yaml(cls, path: str) -> "Config":
    import yaml
    with open(path) as f:
      return cls(yaml.safe_load(f))


def _coerce_like(text: str, like: Any) -> Any:
  """Parse `text` trying to match the type of the existing value `like`.

  A word other than true/false given for a bool key stays a string, so a
  key whose default is False can take a mode ("fused_softmax_loss=pallas").
  automl_tpu's Config turns such a word into False."""
  val = _parse_value(text) if isinstance(text, str) else text
  if isinstance(like, bool) and not isinstance(val, bool):
    if isinstance(val, str):
      return val.lower() == "true" if val.lower() in ("true", "false") else val
    return bool(val)
  if isinstance(like, float) and isinstance(val, int):
    return float(val)
  if isinstance(like, tuple) and isinstance(val, list):
    return tuple(val)
  return val


def _parse_override_str(s: str) -> dict:
  """Parse 'a.b=c,d=e*f' into a nested dict."""
  out: dict = {}
  for item in _split_toplevel_commas(s):
    if "=" not in item:
      raise ValueError(f"Malformed override item {item!r} in {s!r}")
    key, val = item.split("=", 1)
    node = out
    parts = key.strip().split(".")
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = _parse_value(val)
  return out

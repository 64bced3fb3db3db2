"""NestedMap: a dot-accessible nested dict (port of lingvo_tpu/core/nested_map.py).

The reference registers NestedMap as a JAX pytree and gets flatten/pack
for free from `jax.tree_util`. The port has no JAX, so this module keeps
its own small tree walk with the same conventions: dict keys in sorted
order, lists and tuples in order, `None` an empty subtree, anything else
a leaf (a `torch.Tensor`, a numpy array, a number).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterable

_NAME_SEPARATOR = "."
_VALID_KEY_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Attributes of dict/NestedMap itself that must not be shadowed by keys.
_RESERVED = frozenset(dir(dict)) | frozenset(
    ("Flatten", "FlattenItems", "Pack", "Transform", "TransformWithKey",
     "Filter", "FilterKeyVal", "Get", "GetItem", "Set", "Copy", "DeepCopy",
     "IsCompatible", "VLog", "DebugString")
)


def _FlattenWithPath(node: Any, prefix: str, out: list) -> None:
  """Appends (dotted_path, leaf) pairs of `node` to out in stable order."""
  if node is None:
    return
  if isinstance(node, dict):
    for k in sorted(node.keys()):
      key = f"{prefix}{_NAME_SEPARATOR}{k}" if prefix else str(k)
      _FlattenWithPath(node[k], key, out)
    return
  if isinstance(node, (list, tuple)):
    for i, v in enumerate(node):
      _FlattenWithPath(v, f"{prefix}[{i}]", out)
    return
  out.append((prefix, node))


def _Rebuild(node: Any, leaves) -> Any:
  """Same structure as node, with leaves drawn in order from the iterator."""
  if node is None:
    return None
  if isinstance(node, dict):
    out = NestedMap() if isinstance(node, NestedMap) else type(node)()
    for k in sorted(node.keys()):
      dict.__setitem__(out, k, _Rebuild(node[k], leaves))
    return out
  if isinstance(node, (list, tuple)):
    vals = [_Rebuild(v, leaves) for v in node]
    if hasattr(node, "_fields"):     # namedtuple
      return type(node)(*vals)
    return type(node)(vals)
  return next(leaves)


def _Structure(node: Any) -> Any:
  if isinstance(node, dict):
    return ("dict", tuple((k, _Structure(node[k])) for k in sorted(node)))
  if isinstance(node, (list, tuple)):
    return (type(node).__name__, tuple(_Structure(v) for v in node))
  return "none" if node is None else "leaf"


class NestedMap(dict):
  """A dict with attribute access and stable-order flattening."""

  __slots__ = ()

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    for key in self.keys():
      NestedMap.CheckKey(key)

  # ---- attribute access ----------------------------------------------------

  def __getattr__(self, name: str) -> Any:
    try:
      return self[name]
    except KeyError as e:
      raise AttributeError(
          f"'NestedMap' has no attribute {name!r}; keys: {sorted(self.keys())}"
      ) from e

  def __setattr__(self, name: str, value: Any) -> None:
    NestedMap.CheckKey(name)
    self[name] = value

  def __delattr__(self, name: str) -> None:
    try:
      del self[name]
    except KeyError as e:
      raise AttributeError(name) from e

  def __setitem__(self, key: str, value: Any) -> None:
    NestedMap.CheckKey(key)
    super().__setitem__(key, value)

  @staticmethod
  def CheckKey(key: Any) -> None:
    if not isinstance(key, str) or not _VALID_KEY_RE.match(key):
      raise ValueError(f"Invalid NestedMap key {key!r}")
    if key in _RESERVED:
      raise ValueError(f"NestedMap key {key!r} shadows a reserved attribute")

  # ---- copies --------------------------------------------------------------

  def Copy(self) -> "NestedMap":
    """Shallow copy (one level)."""
    return NestedMap(self)

  def DeepCopy(self) -> "NestedMap":
    """Structural copy: containers are rebuilt, leaves are shared."""
    return self.Transform(lambda x: x)

  def __deepcopy__(self, memo):
    import copy as _copy
    result = NestedMap()
    memo[id(self)] = result
    for k, v in self.items():
      super(NestedMap, result).__setitem__(k, _copy.deepcopy(v, memo))
    return result

  # ---- dotted-path get/set -------------------------------------------------

  def Get(self, path: str, default: Any = None) -> Any:
    """Returns the value at dotted `path` ('a.b[0].c' style), or default."""
    try:
      return self.GetItem(path)
    except (KeyError, IndexError, TypeError):
      return default

  def GetItem(self, path: str) -> Any:
    """Returns the value at dotted `path`; raises on missing."""
    current = self
    for part in re.split(r"\.|(\[\d+\])", path):
      if not part:
        continue
      if part.startswith("["):
        current = current[int(part[1:-1])]
      else:
        current = current[part] if isinstance(current, dict) else getattr(
            current, part)
    return current

  def Set(self, path: str, value: Any) -> None:
    """Sets `path` to `value`, creating intermediate NestedMaps as needed."""
    parts = [p for p in re.split(r"\.|(\[\d+\])", path) if p]
    current = self
    for i, part in enumerate(parts[:-1]):
      nxt = parts[i + 1]
      if part.startswith("["):
        idx = int(part[1:-1])
        while len(current) <= idx:
          current.append(NestedMap() if not nxt.startswith("[") else [])
        current = current[idx]
      else:
        if isinstance(current, dict):
          if part not in current or current[part] is None:
            current[part] = [] if nxt.startswith("[") else NestedMap()
          current = current[part]
        else:
          current = getattr(current, part)
    last = parts[-1]
    if last.startswith("["):
      idx = int(last[1:-1])
      while len(current) <= idx:
        current.append(None)
      current[idx] = value
    else:
      current[last] = value

  # ---- flatten / pack ------------------------------------------------------

  def Flatten(self) -> list[Any]:
    """Flattens leaves in sorted-key order (lists flattened in order)."""
    return [leaf for _, leaf in self.FlattenItems()]

  def FlattenItems(self) -> list[tuple[str, Any]]:
    """Returns [(dotted_key, leaf)] in stable order."""
    out: list = []
    _FlattenWithPath(self, "", out)
    return out

  def Pack(self, values: Iterable[Any]) -> "NestedMap":
    """Packs flat `values` back into this map's structure."""
    values = list(values)
    n = len(self.FlattenItems())
    if len(values) != n:
      raise ValueError(f"Pack needs {n} values, got {len(values)}")
    return _Rebuild(self, iter(values))

  # ---- transforms ----------------------------------------------------------

  def Transform(self, fn: Callable[[Any], Any]) -> "NestedMap":
    """Applies fn to every leaf; returns a new NestedMap."""
    return self.Pack([fn(v) for v in self.Flatten()])

  def TransformWithKey(self, fn: Callable[[str, Any], Any]) -> "NestedMap":
    return self.Pack([fn(k, v) for k, v in self.FlattenItems()])

  def Filter(self, fn: Callable[[Any], bool]) -> "NestedMap":
    """Keeps only leaves where fn(value); prunes empty subtrees."""
    return self.FilterKeyVal(lambda _, v: fn(v))

  def FilterKeyVal(self, fn: Callable[[str, Any], bool]) -> "NestedMap":
    """Keeps only leaves where fn(dotted_key, value); prunes empty subtrees."""

    def _Recurse(node: Any, prefix: str) -> Any:
      if isinstance(node, dict):
        out = NestedMap()
        for k in node:
          key = f"{prefix}{_NAME_SEPARATOR}{k}" if prefix else k
          sub = _Recurse(node[k], key)
          if sub is not _PRUNE:
            out[k] = sub
        return out if out else _PRUNE
      if isinstance(node, (list, tuple)):
        if hasattr(node, "_fields"):  # namedtuple: all-or-nothing leaf
          return node if fn(prefix, node) else _PRUNE
        # Preserve arity: pruned elements become None placeholders so indices
        # in the filtered tree still correspond to the original tree.
        out_l = []
        any_kept = False
        for i, v in enumerate(node):
          sub = _Recurse(v, f"{prefix}[{i}]")
          if sub is _PRUNE:
            out_l.append(None)
          else:
            any_kept = True
            out_l.append(sub)
        if not any_kept:
          return _PRUNE
        return type(node)(out_l) if isinstance(node, tuple) else out_l
      return node if fn(prefix, node) else _PRUNE

    result = _Recurse(self, "")
    return NestedMap() if result is _PRUNE else result

  def IsCompatible(self, other: "NestedMap") -> bool:
    """True iff `other` has the same nested structure."""
    return _Structure(self) == _Structure(other)

  def DebugString(self) -> str:
    return "\n".join(f"{k}: {v!r}" for k, v in self.FlattenItems())


class _Prune:
  pass


_PRUNE = _Prune()

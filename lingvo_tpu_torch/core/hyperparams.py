"""Params: typed, frozen-schema configuration trees (experiments-as-code).

Re-implements the semantics of the reference's config system
(`lingvo/core/hyperparams.py:266,1129`): every object in the framework is built
from a serializable `Params` tree created by `cls.Params()`, overridden in
experiment subclasses, and instantiated with `p.Instantiate()`. Text
round-tripping (`ToText`/`FromText`) gives full reproducibility of every run.

Design differences from the reference (deliberate, TPU-native):
  * no proto serialization — text format only (the text format IS the schema);
  * values may be arbitrary Python/JAX objects; only text-representable ones
    round-trip;
  * `Instantiate()` threads no TF graph state; instantiated layers are pure.
"""

from __future__ import annotations

import ast
import copy as _copy
import dataclasses
import enum
import inspect
import re
from typing import Any, Callable, TypeVar

T = TypeVar("T")


@dataclasses.dataclass
class _Param:
  name: str
  default: Any
  description: str


def _QuoteString(s: str) -> str:
  return repr(s)


# Types whose repr() is a constructor call with literal args; they round-trip
# through ToText/FromText. Register with RegisterSerializableType.
_SERIALIZABLE_TYPES: dict[str, type] = {}


def RegisterSerializableType(cls: type) -> type:
  _SERIALIZABLE_TYPES[cls.__name__] = cls
  return cls


def _IsNamedTuple(x: Any) -> bool:
  return isinstance(x, tuple) and hasattr(x, "_fields")


class Params:
  """An ordered, schema-frozen mapping of name -> value with nesting.

  Attribute access reads/writes parameter values. New parameters can only be
  added via `Define` (so typos in experiment overrides fail loudly).
  """

  _immutable: bool

  def __init__(self):
    self.__dict__["_params"] = {}  # name -> _Param
    self.__dict__["_immutable"] = False

  # ---- schema --------------------------------------------------------------

  def Define(self, name: str, default: Any, description: str) -> None:
    """Defines a new parameter with a default value and docstring."""
    if self._immutable:
      raise TypeError(f"This Params instance is immutable: {self}")
    if not re.match(r"^[a-z][a-z0-9_]*$", name):
      raise AttributeError(f"Parameter name must be lowercase_snake: {name!r}")
    if name in self._params:
      raise AttributeError(f"Parameter {name!r} is already defined")
    self._params[name] = _Param(name, default, description)

  def Delete(self, *names: str) -> "Params":
    """Removes parameters from the schema. Returns self."""
    if self._immutable:
      raise TypeError(f"This Params instance is immutable: {self}")
    for name in names:
      if name not in self._params:
        raise AttributeError(f"Parameter {name!r} not found")
      del self._params[name]
    return self

  # ---- value access --------------------------------------------------------

  def __getattr__(self, name: str) -> Any:
    if name.startswith("_"):
      raise AttributeError(name)
    params = self.__dict__["_params"]
    try:
      return params[name].default
    except KeyError as e:
      raise AttributeError(
          f"{name!r} not defined; known params: {sorted(params)}") from e

  def __setattr__(self, name: str, value: Any) -> None:
    if self._immutable:
      raise TypeError(f"This Params instance is immutable; cannot set {name}")
    params = self.__dict__["_params"]
    if name not in params:
      raise AttributeError(
          f"{name!r} not defined via Define(); known params: {sorted(params)}")
    params[name].default = value

  def Get(self, path: str) -> Any:
    """Gets a (possibly dotted) parameter value."""
    current: Any = self
    for part in path.split("."):
      current = getattr(current, part)
    return current

  def Set(self, **kwargs: Any) -> "Params":
    """Sets multiple parameters (dotted names use __ as separator). Returns self."""
    for name, value in kwargs.items():
      parts = name.split("__")
      target = self
      for part in parts[:-1]:
        target = getattr(target, part)
      setattr(target, parts[-1], value)
    return self

  def SetPath(self, path: str, value: Any) -> "Params":
    """Sets a dotted-path parameter. Returns self."""
    parts = path.split(".")
    target = self
    for part in parts[:-1]:
      target = getattr(target, part)
    setattr(target, parts[-1], value)
    return self

  def __contains__(self, name: str) -> bool:
    return name in self._params

  def Has(self, name: str) -> bool:
    return name in self._params

  def IterParams(self):
    for name, p in self._params.items():
      yield name, p.default

  def GetKeys(self) -> list[str]:
    return sorted(self._params.keys())

  def __len__(self) -> int:
    return len(self._params)

  # ---- copy / freeze -------------------------------------------------------

  def Copy(self) -> "Params":
    """Deep copy (sub-Params deep-copied; other values copy.deepcopy'd)."""
    return self._CopyTo(type(self)())

  def _CopyTo(self, res: "Params") -> "Params":
    res.__dict__["_params"] = {}
    for name, p in self._params.items():
      if isinstance(p.default, Params):
        v = p.default.Copy()
      else:
        try:
          v = _copy.deepcopy(p.default)
        except TypeError:
          # runtime handles (jax Mesh/Device objects, callables bound to
          # device state) are not picklable — share the reference, like the
          # reference shares non-copyable param values
          v = p.default
      res.__dict__["_params"][name] = _Param(name, v, p.description)
    if isinstance(res, InstantiableParams) and isinstance(
        self, InstantiableParams):
      res.__dict__["_cls"] = self.__dict__["_cls"]
    return res

  def __deepcopy__(self, memo):
    result = self.Copy()
    memo[id(self)] = result
    return result

  def Freeze(self) -> "Params":
    """Makes this Params tree immutable (recursively). Returns self."""
    self.__dict__["_immutable"] = True
    for p in self._params.values():
      if isinstance(p.default, Params):
        p.default.Freeze()
    return self

  @property
  def is_immutable(self) -> bool:
    return self._immutable

  # ---- equality / repr -----------------------------------------------------

  def __eq__(self, other: Any) -> bool:
    if not isinstance(other, Params):
      return NotImplemented
    if set(self._params) != set(other._params):
      return False
    for name, p in self._params.items():
      if p.default != other._params[name].default:
        return False
    return True

  def __ne__(self, other):
    eq = self.__eq__(other)
    return eq if eq is NotImplemented else not eq

  def __repr__(self) -> str:
    return self.ToText()

  def __str__(self) -> str:
    return self.ToText()

  # ---- text serialization --------------------------------------------------

  def ToText(self, prefix: str = "") -> str:
    """Serializes to 'dotted.key : value' lines, sorted by key."""
    lines: list[str] = []

    def _Append(key: str, value: Any):
      lines.append(f"{key} : {_ValueToText(value)}")

    def _Walk(params: "Params", prefix: str):
      for name in sorted(params._params):
        v = params._params[name].default
        key = f"{prefix}{name}"
        if isinstance(v, Params):
          if isinstance(v, InstantiableParams):
            lines.append(f"{key}.cls : {_ClassToText(v.cls)}")
          _Walk(v, key + ".")
        else:
          _Append(key, v)

    if isinstance(self, InstantiableParams):
      lines.append(f"{prefix}cls : {_ClassToText(self.cls)}")
    _Walk(self, prefix)
    return "\n".join(lines) + "\n"

  def FromText(self, text: str) -> "Params":
    """Applies 'key : value' lines to this tree. Values parsed as literals.

    Only keys already in the schema are set ('cls' lines are checked to match,
    not used to construct — reconstruction requires the experiment code, which
    is the reference's behavior too).
    """
    if self._immutable:
      raise TypeError("Cannot FromText on immutable Params")
    for line in text.splitlines():
      line = line.strip()
      if not line or line.startswith("#"):
        continue
      if " : " not in line:
        raise ValueError(f"Malformed params line: {line!r}")
      key, value_text = line.split(" : ", 1)
      key = key.strip()
      if key == "cls" or key.endswith(".cls"):
        continue
      target: Any = self
      parts = key.split(".")
      for part in parts[:-1]:
        target = getattr(target, part)
      setattr(target, parts[-1], _TextToValue(value_text.strip()))
    return self

  def TextDiff(self, other: "Params") -> str:
    """Returns a human-readable diff of two Params trees."""
    mine = dict(
        line.split(" : ", 1) for line in self.ToText().splitlines() if line)
    theirs = dict(
        line.split(" : ", 1) for line in other.ToText().splitlines() if line)
    out = []
    for k in sorted(set(mine) | set(theirs)):
      a, b = mine.get(k), theirs.get(k)
      if a != b:
        out.append(f"{k}: {a} -> {b}")
    return "\n".join(out)


class InstantiableParams(Params):
  """Params bound to a class; `Instantiate()` constructs cls(params)."""

  def __init__(self, cls: type | None = None):
    super().__init__()
    self.__dict__["_cls"] = cls

  @property
  def cls(self) -> type:
    return self.__dict__["_cls"]

  def SetClass(self, cls: type) -> "InstantiableParams":
    """Rebinds the class to instantiate (e.g. policy wrappers subclassing
    the original cls, ref input_policy.py); returns self for chaining."""
    self.__dict__["_cls"] = cls
    return self

  def Instantiate(self, **kwargs: Any):
    """Constructs the bound class with this params tree."""
    if self.cls is None:
      raise ValueError("InstantiableParams has no bound class")
    return self.cls(self, **kwargs)

  def Copy(self) -> "InstantiableParams":
    return self._CopyTo(type(self)(self.cls))


def _ClassToText(cls: type | None) -> str:
  if cls is None:
    return "None"
  return f"type/{cls.__module__}/{cls.__qualname__}"


def _ValueToText(v: Any) -> str:
  if isinstance(v, str):
    return _QuoteString(v)
  if isinstance(v, enum.Enum):
    return f"enum/{type(v).__module__}/{type(v).__qualname__}/{v.name}"
  if inspect.isclass(v):
    return _ClassToText(v)
  if callable(v):
    mod = getattr(v, "__module__", "?")
    name = getattr(v, "__qualname__", getattr(v, "__name__", repr(v)))
    return f"callable/{mod}/{name}"
  if isinstance(v, dict) and not v:
    return "{}"
  if _IsNamedTuple(v):
    return repr(v)
  return repr(v)


def _TextToValue(text: str) -> Any:
  if text == "None":
    return None
  if text in ("True", "False"):
    return text == "True"
  if text.startswith(("type/", "callable/")):
    _, mod, qualname = text.split("/", 2)
    import importlib
    obj: Any = importlib.import_module(mod)
    for part in qualname.split("."):
      obj = getattr(obj, part)
    return obj
  if text.startswith("enum/"):
    _, mod, rest = text.split("/", 2)
    qualname, member = rest.rsplit("/", 1)
    import importlib
    obj = importlib.import_module(mod)
    for part in qualname.split("."):
      obj = getattr(obj, part)
    return obj[member]
  try:
    return ast.literal_eval(text)
  except (ValueError, SyntaxError):
    pass
  # Registered dataclass-style reprs: Name(k=literal, ...).
  m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)\(", text)
  if m and m.group(1) in _SERIALIZABLE_TYPES:
    cls = _SERIALIZABLE_TYPES[m.group(1)]
    try:
      node = ast.parse(text, mode="eval").body
      if isinstance(node, ast.Call):
        args = [ast.literal_eval(a) for a in node.args]
        kwargs = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
        return cls(*args, **kwargs)
    except (ValueError, SyntaxError):
      pass
  raise ValueError(
      f"Cannot parse params value {text!r}; non-literal types must be "
      "registered with hyperparams.RegisterSerializableType")

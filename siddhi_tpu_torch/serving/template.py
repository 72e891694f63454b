"""Parameterized SiddhiQL templates: register once, instantiate per
tenant (PyTorch port of siddhi_tpu/serving/template.py; host code,
copied).

A template is ordinary SiddhiQL text plus two placeholder kinds:

- ``${name:type}`` — a TENANT VALUE parameter (type one of int/long/
  float/double/bool/string). It parses into an ``A.TemplateParam`` node
  and lowers to a runtime load of a per-tenant parameter carried in the
  operator's state (ops/expr.py, kernel K2's parameter load), so every
  tenant of the template shares one planned step and only the stacked
  parameter values differ. Allowed in filter conditions and
  non-aggregating select/having (the ``template-binding`` plan rule).
- ``${name}`` — a STRUCTURAL placeholder (stream refs, window sizes,
  anything that shapes the planned step). Substituted textually from
  the pool's ``shared`` bindings BEFORE parsing; the (template hash,
  shared bindings) pair keys the pool.

Templates are HASH-KEYED on whitespace-normalized text: two tenants
posting byte-different but content-identical templates land on the same
registry entry and the same pool.
"""
from __future__ import annotations

import hashlib
import re
import threading
from typing import Optional

from ..core.types import AttrType, can_coerce
from ..lang import ast as A
from ..ops.expr import CompileError

# `${name}` or `${name:type}` — the same surface the lexer tokenizes
_PLACEHOLDER_RE = re.compile(r"\$\{(\w+)(?::(\w+))?\}")
_APPNAME_RE = re.compile(r"@app:name\(\s*['\"][^'\"]*['\"]\s*\)\s*")

_TYPES = {
    "int": AttrType.INT, "long": AttrType.LONG,
    "float": AttrType.FLOAT, "double": AttrType.DOUBLE,
    "bool": AttrType.BOOL, "string": AttrType.STRING,
}


# single source for value->AttrType literal classification (the
# template-binding rule and literal rendering must agree on it)
from ..analysis.plan_rules import _literal_type  # noqa: E402


def render_literal(value, t: AttrType) -> str:
    """Render a Python value as a SiddhiQL literal of type ``t`` (static
    instantiation: the separate-runtimes baseline and one-off deploys)."""
    lt = _literal_type(value)
    if lt is None or not can_coerce(lt, t):
        raise CompileError(
            f"template-binding: value {value!r} does not render as a "
            f"{t.value.upper()} literal")
    if t is AttrType.BOOL:
        return "true" if value else "false"
    if t is AttrType.STRING:
        return "'" + str(value).replace("'", "\\'") + "'"
    if t is AttrType.INT:
        return str(int(value))
    if t is AttrType.LONG:
        return f"{int(value)}L"
    if t is AttrType.FLOAT:
        return f"{float(value)!r}f"
    # DOUBLE: a bare decimal literal; repr always carries '.' or 'e'
    return repr(float(value))


class Template:
    """One registered template: raw text, content hash, placeholder split
    into tenant value params (typed) and structural names (untyped)."""

    def __init__(self, text: str, name: Optional[str] = None):
        self.text = text
        norm = "\n".join(ln.strip() for ln in text.strip().splitlines()
                         if ln.strip())
        self.key = hashlib.sha256(norm.encode()).hexdigest()[:16]
        self.name = name or f"tpl_{self.key[:8]}"
        self.value_params: dict[str, AttrType] = {}
        self.structural: set[str] = set()
        for pname, typename in _PLACEHOLDER_RE.findall(text):
            if not typename:
                if pname in self.value_params:
                    raise CompileError(
                        f"template-binding: placeholder '${{{pname}}}' "
                        "used both typed and untyped")
                self.structural.add(pname)
                continue
            t = _TYPES.get(typename.lower())
            if t is None:
                raise CompileError(
                    f"template-binding: unknown placeholder type "
                    f"'{typename}' in '${{{pname}:{typename}}}' "
                    f"(expected one of {', '.join(sorted(_TYPES))})")
            if pname in self.structural:
                raise CompileError(
                    f"template-binding: placeholder '${{{pname}}}' "
                    "used both typed and untyped")
            prev = self.value_params.get(pname)
            if prev is not None and prev is not t:
                raise CompileError(
                    f"template-binding: placeholder '${{{pname}}}' "
                    f"declared with conflicting types {prev.value} and "
                    f"{t.value}")
            self.value_params[pname] = t

    # -- text assembly ---------------------------------------------------

    def app_text(self, shared: Optional[dict] = None,
                 app_name: Optional[str] = None) -> str:
        """Template text with STRUCTURAL placeholders substituted from
        ``shared`` (raw text: identifiers go in bare, literal values via
        str()) and the @app:name rewritten. Typed placeholders remain for
        the template-mode parse."""
        shared = dict(shared or {})
        unknown = sorted(set(shared) - self.structural)
        if unknown:
            raise CompileError(
                "template-binding: shared binding(s) "
                f"{', '.join(unknown)} name no structural placeholder "
                f"(structural: {', '.join(sorted(self.structural)) or 'none'})")
        missing = sorted(self.structural - set(shared))
        if missing:
            raise CompileError(
                "template-binding: unbound structural placeholder(s) "
                + ", ".join(f"${{{m}}}" for m in missing)
                + " — pass them via shared=")

        def sub(m):
            pname, typename = m.group(1), m.group(2)
            if typename:
                return m.group(0)          # tenant param: leave for parse
            return str(shared[pname])
        text = _PLACEHOLDER_RE.sub(sub, self.text)
        if app_name is not None:
            text = "@app:name('%s')\n%s" % (app_name,
                                            _APPNAME_RE.sub("", text))
        return text

    def instantiate(self, shared: Optional[dict] = None,
                    app_name: Optional[str] = None) -> A.SiddhiApp:
        """Parse in template mode: typed placeholders stay as
        TemplateParam nodes (per-tenant runtime parameters); the
        template-binding plan rule and the typechecker both run."""
        from ..lang.parser import parse
        return parse(self.app_text(shared, app_name), template=True)

    def instantiate_static(self, bindings: dict,
                           shared: Optional[dict] = None,
                           app_name: Optional[str] = None) -> str:
        """Fully-bound SiddhiQL text: every typed placeholder replaced by
        the binding rendered as a literal of the declared type: the
        one-runtime-per-tenant baseline a pool is held against, and the
        escape hatch for deploying a template as a plain app."""
        unknown = sorted(set(bindings) - set(self.value_params))
        if unknown:
            raise CompileError(
                f"template-binding: unknown placeholder(s) "
                f"{', '.join(unknown)}")
        missing = sorted(set(self.value_params) - set(bindings))
        if missing:
            raise CompileError(
                "template-binding: unbound placeholder(s) "
                + ", ".join(f"${{{m}}}" for m in missing))
        text = self.app_text(shared, app_name)

        def sub(m):
            pname, typename = m.group(1), m.group(2)
            if not typename:
                return m.group(0)
            return render_literal(bindings[pname],
                                  self.value_params[pname])
        return _PLACEHOLDER_RE.sub(sub, text)


class TemplateRegistry:
    """Hash-keyed template store + pool cache: tenants instantiating the
    same (template, shared-bindings) pair share ONE TenantPool and
    therefore one planned step set (built, and with ``warm`` its
    kernels loaded, at pool creation)."""

    def __init__(self, manager=None):
        from ..core.manager import SiddhiManager
        self.manager = manager or SiddhiManager()
        self._templates: dict[str, Template] = {}    # key -> Template
        self._names: dict[str, str] = {}             # name -> key
        self._pools: dict[tuple, "TenantPool"] = {}
        self._lock = threading.RLock()

    def register(self, text: str, name: Optional[str] = None) -> Template:
        tpl = Template(text, name=name)
        with self._lock:
            existing = self._templates.get(tpl.key)
            if existing is None:
                self._templates[tpl.key] = tpl
                existing = tpl
            self._names.setdefault(existing.name, existing.key)
            if name:
                self._names[name] = existing.key
        return existing

    def get(self, ref: str) -> Optional[Template]:
        """Template by registered name or content key."""
        with self._lock:
            key = self._names.get(ref, ref)
            return self._templates.get(key)

    def resolve(self, template) -> Template:
        """Template object | registered name/key | inline SiddhiQL text."""
        if isinstance(template, Template):
            with self._lock:
                return self._templates.setdefault(template.key, template)
        got = self.get(template)
        if got is not None:
            return got
        return self.register(template)

    def pool(self, template, shared: Optional[dict] = None,
             warm: bool = True, **pool_kwargs) -> "TenantPool":
        """The ONE TenantPool for (template, shared bindings) — created
        (and warmed, see TenantPool.warmup) on first use, returned as-is
        afterwards (``pool_kwargs`` only apply at creation)."""
        from .pool import TenantPool
        tpl = self.resolve(template)
        shared_key = tuple(sorted((shared or {}).items()))
        pkey = (tpl.key, shared_key)
        with self._lock:
            pool = self._pools.get(pkey)
            if pool is not None:
                return pool
            name = pool_kwargs.pop(
                "name", f"pool_{tpl.key[:8]}"
                + (f"_s{len([k for k in self._pools if k[0] == tpl.key])}"
                   if shared_key else ""))
            pool = TenantPool(tpl, shared=dict(shared or {}),
                              manager=self.manager, name=name,
                              **pool_kwargs)
            self._pools[pkey] = pool
        if warm:
            pool.warmup()
        return pool

    @property
    def pools(self) -> dict:
        with self._lock:
            return dict(self._pools)

    def shutdown(self) -> None:
        for pool in self.pools.values():
            pool.shutdown()
        with self._lock:
            self._pools.clear()

"""Tenant templates (siddhi_tpu_torch/serving/template.py) against the
reference's (siddhi_tpu/serving/template.py), on the CPU.

Keys (the sha256 of the whitespace-normalised text), placeholder splits,
app text with shared structural bindings, static instantiation with
every literal type, the registry's dedup and pool sharing, and every
error text are the reference's, string for string."""
import pytest
import torch

import siddhi_tpu as J
import siddhi_tpu_torch as T
from siddhi_tpu.ops.expr import CompileError as JCompileError
from siddhi_tpu.serving import Template as JTemplate
from siddhi_tpu.serving import TemplateRegistry as JRegistry
from siddhi_tpu.serving.template import render_literal as j_render
from siddhi_tpu_torch.core.types import AttrType as TAttr
from siddhi_tpu.core.types import AttrType as JAttr
from siddhi_tpu_torch.ops.expr import CompileError as TCompileError
from siddhi_tpu_torch.serving import Template as TTemplate
from siddhi_tpu_torch.serving import TemplateRegistry as TRegistry
from siddhi_tpu_torch.serving.template import render_literal as t_render

torch.set_num_threads(1)

TPL = """
define stream In (v double, k long, s string, b bool, n int);
@info(name='q')
from In[v > ${lo:double} and v < ${hi:double} and s == ${who:string}]
select v, k, ${tag:int} as tag, ${flag:bool} as flag
insert into ${out};
"""

TEXTS = {
    "params": TPL,
    "spaced": "\n\n   " + TPL.replace("\n", "\n    ") + "\n\n",
    "static": "define stream In (v double);\nfrom In[v > 1.0] select v "
              "insert into Out;",
    "named": "@app:name('zz')\ndefine stream In (v double);\n"
             "from In[v > ${x:long}] select v insert into Out;",
}

BAD = {
    "conflict": "define stream S (v double);\nfrom S[v > ${a:int} and "
                "v < ${a:double}] select v insert into O;",
    "both_kinds": "define stream S (v double);\nfrom S[v > ${a:int}] "
                  "select v insert into ${a};",
    "unknown_type": "define stream S (v double);\nfrom S[v > "
                    "${a:decimal}] select v insert into O;",
}


def both(fn):
    """fn(package) in both packages -> (result or error text) pair."""
    out = []
    for tpl, err in ((JTemplate, JCompileError), (TTemplate, TCompileError)):
        try:
            out.append(("ok", fn(tpl)))
        except err as e:
            out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_template_key_params_and_app_text(name):
    text = TEXTS[name]
    j, t = JTemplate(text), TTemplate(text)
    assert t.key == j.key and t.name == j.name
    assert {k: v.value for k, v in t.value_params.items()} == \
        {k: v.value for k, v in j.value_params.items()}
    assert t.structural == j.structural
    shared = {"out": "Out"} if j.structural else {}
    assert t.app_text(shared, app_name="pool_x") == \
        j.app_text(shared, app_name="pool_x")


def test_whitespace_normalised_keys_agree():
    assert TTemplate(TEXTS["params"]).key == TTemplate(TEXTS["spaced"]).key
    assert JTemplate(TEXTS["spaced"]).key == TTemplate(TEXTS["spaced"]).key


@pytest.mark.parametrize("name", sorted(BAD))
def test_template_errors_are_the_reference_texts(name):
    j, t = both(lambda tpl: tpl(BAD[name]).key)
    assert j[0] == t[0] == "error"
    assert t[1] == j[1]


@pytest.mark.parametrize("shared", [{}, {"out": "Out", "extra": 1},
                                    {"extra": 1}])
def test_shared_binding_errors(shared):
    j, t = both(lambda tpl: tpl(TPL).app_text(shared))
    assert j == t and j[0] == "error"


BINDINGS = [
    {"lo": 1.5, "hi": 2, "who": "it's", "tag": 7, "flag": True},
    {"lo": -0.0, "hi": 1e300, "who": "", "tag": -2 ** 31, "flag": False},
    {"lo": 1.0, "hi": 2.0, "who": "x", "tag": 7},              # unbound
    {"lo": 1.0, "hi": 2.0, "who": "x", "tag": 7, "flag": 1,
     "zz": 3},                                                 # unknown
]


@pytest.mark.parametrize("k", range(len(BINDINGS)))
def test_instantiate_static(k):
    j, t = both(lambda tpl: tpl(TPL).instantiate_static(
        BINDINGS[k], shared={"out": "Out"}, app_name="a"))
    assert j == t


@pytest.mark.parametrize("value,typ", [
    (3, "INT"), (3, "LONG"), (3, "DOUBLE"), (2.5, "FLOAT"), (True, "BOOL"),
    ("a'b", "STRING"), (2.5, "INT"), ("x", "DOUBLE"), (None, "INT"),
    (2 ** 40, "INT"), (2 ** 40, "LONG")])
def test_render_literal(value, typ):
    def run(render, attr, err):
        try:
            return ("ok", render(value, getattr(attr, typ)))
        except err as e:
            return ("error", str(e))
    assert run(t_render, TAttr, TCompileError) == \
        run(j_render, JAttr, JCompileError)


def test_instantiate_parses_template_params():
    app = TTemplate(TPL).instantiate(shared={"out": "Out"}, app_name="p")
    assert app.name == "p"
    with pytest.raises(TCompileError) as te:
        TTemplate(TPL).instantiate(shared={}, app_name="p")
    with pytest.raises(JCompileError) as je:
        JTemplate(TPL).instantiate(shared={}, app_name="p")
    assert str(te.value) == str(je.value)


def test_registry_dedups_and_shares_pools():
    regs = (JRegistry(J.SiddhiManager()),
            TRegistry(T.SiddhiManager(device="cpu")))
    for reg in regs:
        a = reg.register(TEXTS["params"], name="first")
        b = reg.register(TEXTS["spaced"])
        assert a is b and reg.get("first") is a and reg.get(a.key) is a
        assert reg.resolve("first") is a
        p1 = reg.pool("first", shared={"out": "Out"}, warm=False, slots=2)
        p2 = reg.pool(TEXTS["spaced"], shared={"out": "Out"}, warm=False)
        p3 = reg.pool(TEXTS["params"], shared={"out": "Out2"}, warm=False)
        assert p1 is p2 and p3 is not p1
        assert p1.name == f"pool_{a.key[:8]}_s0"
        assert p3.name == f"pool_{a.key[:8]}_s1"
        assert set(reg.pools) == {(a.key, (("out", "Out"),)),
                                  (a.key, (("out", "Out2"),))}
        reg.shutdown()
        assert reg.pools == {}


@pytest.mark.parametrize("bindings", [
    {"lo": 1.0, "hi": 2.0, "who": "x", "tag": 7, "flag": True},
    {"lo": "one", "hi": 2.0, "who": "x", "tag": 7, "flag": True},
    {"lo": 1.0, "hi": 2.0, "who": 3, "tag": 2 ** 40, "flag": True},
    {"hi": 2.0, "who": "x", "tag": 7, "flag": True, "nope": 1}])
def test_pool_binding_errors(bindings):
    out = []
    for reg, err in ((JRegistry(J.SiddhiManager()), JCompileError),
                     (TRegistry(T.SiddhiManager(device="cpu")),
                      TCompileError)):
        pool = reg.pool(TPL, shared={"out": "Out"}, warm=False, slots=2)
        try:
            out.append(("ok", pool.add_tenant("t", bindings)))
        except err as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]

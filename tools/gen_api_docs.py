#!/usr/bin/env python
"""Generate the markdown API reference under docs/api/ — the reference's
doxygen layer analog (/root/reference/docs/doxygen/), dependency-free.

Walks every module in ``liquiddsp_tpu``, imports it (CPU backend), and
emits one markdown file per module: module docstring, then each public
function (signature + docstring) and class (docstring + public methods)
defined in that module. Regenerate with:

    python tools/gen_api_docs.py
"""

import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

sys.path.insert(0, ".")

from liquiddsp_tpu.utils.init import init_device  # noqa: E402

init_device(cpu=True)

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "docs" / "api"


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(undocumented)*"


def _document_class(cls, lines: list[str]):
    lines.append(f"### class `{cls.__name__}`\n")
    lines.append(_doc(cls) + "\n")
    for name, member in inspect.getmembers(cls):
        if name.startswith("_") and name != "__init__":
            continue
        if not (inspect.isfunction(member) or inspect.ismethod(member)):
            continue
        if member.__qualname__.split(".")[0] != cls.__name__:
            continue  # inherited
        label = "constructor" if name == "__init__" else f"`.{name}`"
        lines.append(f"#### {label} `{name}{_signature(member)}`\n")
        lines.append(_doc(member) + "\n")


def document_module(modname: str) -> str | None:
    try:
        mod = importlib.import_module(modname)
    except Exception as e:  # noqa: BLE001 — skip optional/native-gated modules
        return f"# `{modname}`\n\n*(import failed: {type(e).__name__}: {e})*\n"
    lines = [f"# `{modname}`\n"]
    lines.append(_doc(mod) + "\n")
    funcs, classes = [], []
    for name, member in inspect.getmembers(mod):
        if name.startswith("_"):
            continue
        if getattr(member, "__module__", None) != modname:
            continue
        if inspect.isfunction(member):
            funcs.append((name, member))
        elif inspect.isclass(member):
            classes.append((name, member))
    if funcs:
        lines.append("## Functions\n")
        for name, fn in funcs:
            lines.append(f"### `{name}{_signature(fn)}`\n")
            lines.append(_doc(fn) + "\n")
    if classes:
        lines.append("## Classes\n")
        for _, cls in classes:
            _document_class(cls, lines)
    return "\n".join(lines) + "\n"


def main():
    import liquiddsp_tpu

    OUT.mkdir(parents=True, exist_ok=True)
    modnames = ["liquiddsp_tpu"]
    for info in pkgutil.walk_packages(
        liquiddsp_tpu.__path__, prefix="liquiddsp_tpu."
    ):
        modnames.append(info.name)
    index = [
        "# liquiddsp_tpu API reference\n",
        "Generated by `python tools/gen_api_docs.py` (stdlib inspect; the",
        "reference's doxygen layer analog). One page per module:\n",
    ]
    for modname in sorted(modnames):
        text = document_module(modname)
        if text is None:
            continue
        fname = modname.replace(".", "_") + ".md"
        (OUT / fname).write_text(text)
        first = ""
        try:
            mod = importlib.import_module(modname)
            d = inspect.getdoc(mod)
            first = (d or "").strip().split("\n")[0]
        except Exception:  # noqa: BLE001
            pass
        index.append(f"- [`{modname}`]({fname}) — {first}")
    (OUT / "README.md").write_text("\n".join(index) + "\n")
    print(f"wrote {len(modnames)} module pages to {OUT}")


if __name__ == "__main__":
    main()

"""URL pattern trie with the reference's wildcard semantics (the port's own
copy of ``webradio_tpu.web.routes``).

Patterns split on '/', where ``*`` matches exactly one path component and
``**`` matches the entire remainder; matched components are handed to the
handler as a wildcard list (httpserver.h:169-174, httpserver.cxx:278-343).
Literal components take precedence over ``*``, which takes precedence over
``**``, at each level.
"""

from __future__ import annotations

from typing import Any


class _Node:
    __slots__ = ("children", "star", "double_star", "handler")

    def __init__(self):
        self.children: dict[str, _Node] = {}
        self.star: _Node | None = None
        self.double_star = None  # terminal (factory, arg) for '**'
        self.handler = None  # terminal (factory, arg) at exact depth


class UrlTree:
    """Routing trie: ``register('tuners/*/waterfall', factory, arg)``."""

    def __init__(self):
        self._root = _Node()

    @staticmethod
    def _split(path: str) -> list[str]:
        return [c for c in path.split("/") if c != ""]

    def register(self, pattern: str, factory, arg: Any = None) -> None:
        node = self._root
        comps = self._split(pattern)
        for i, comp in enumerate(comps):
            if comp == "**":
                if i != len(comps) - 1:
                    raise ValueError("'**' must be the final component")
                node.double_star = (factory, arg)
                return
            if comp == "*":
                if node.star is None:
                    node.star = _Node()
                node = node.star
            else:
                node = node.children.setdefault(comp, _Node())
        node.handler = (factory, arg)

    def find(self, path: str):
        """Return ``(factory, arg, wildcards)`` or ``None``.

        Each ``*`` contributes its matched component to ``wildcards``; ``**``
        contributes the joined remainder (httpserver.cxx:291-343).
        """
        comps = self._split(path)

        def descend(node: _Node, i: int, wilds: list[str]):
            if i == len(comps):
                if node.handler is not None:
                    return node.handler, wilds
                if node.double_star is not None:
                    return node.double_star, wilds + [""]
                return None
            comp = comps[i]
            child = node.children.get(comp)
            if child is not None:
                r = descend(child, i + 1, wilds)
                if r is not None:
                    return r
            if node.star is not None:
                r = descend(node.star, i + 1, wilds + [comp])
                if r is not None:
                    return r
            if node.double_star is not None:
                return node.double_star, wilds + ["/".join(comps[i:])]
            return None

        r = descend(self._root, 0, [])
        if r is None:
            return None
        (factory, arg), wilds = r
        return factory, arg, wilds

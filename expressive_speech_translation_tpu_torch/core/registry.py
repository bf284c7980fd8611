"""Generic component registry (the JAX package's ``core/registry.py``).

Used for translation backends (parity with TranslationManager.register_backend,
services/translation_strategy.py:44), model families, kernel variants and
evaluation metrics. Keeps registration order so "fall back to the first
registered backend" semantics (translation_strategy.py:60-66) are preserved.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, Optional, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}
        self._default: Optional[str] = None

    def register(self, name: str, item: T, *, is_default: bool = False) -> T:
        if name in self._items:
            raise ValueError(f"{self.kind} {name!r} already registered")
        self._items[name] = item
        if is_default or self._default is None:
            self._default = name
        return item

    def decorator(self, name: str, *, is_default: bool = False) -> Callable[[T], T]:
        def wrap(item: T) -> T:
            return self.register(name, item, is_default=is_default)

        return wrap

    def get(self, name: Optional[str] = None) -> T:
        if not self._items:
            raise KeyError(f"no {self.kind} registered")
        key = name or self._default
        if key not in self._items:
            # an unknown name falls back to the default registration
            # (translation_strategy.py:60-66)
            key = self._default
        assert key is not None
        return self._items[key]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def names(self) -> list[str]:
        return list(self._items)

    @property
    def default_name(self) -> Optional[str]:
        return self._default

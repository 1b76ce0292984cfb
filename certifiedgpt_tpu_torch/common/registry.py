"""Component registry of the PyTorch port.

A copy of ``certifiedgpt_tpu/common/registry.py`` with its own tables, so
that the port's builders, processors, models and agents register under the
JAX package's public names (``image_text_certify``, ``minigpt4``,
``blip2_image_val``, ``evalvqav2``, ...) without meeting the JAX package's
classes when both packages live in one process. Besides the name -> class
tables it keeps a dotted-key state store for paths and shared singletons
(logger, configuration).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Type


class Registry:
    mapping: Dict[str, Dict[str, Any]] = {
        "builder_name_mapping": {},
        "processor_name_mapping": {},
        "model_name_mapping": {},
        "agent_name_mapping": {},
        "lr_scheduler_name_mapping": {},
        "state": {},
        "paths": {},
    }

    # ------------------------------------------------------------------
    # decorators
    # ------------------------------------------------------------------
    @classmethod
    def _register(cls, table: str, name: str) -> Callable[[Type], Type]:
        def wrap(target: Type) -> Type:
            existing = cls.mapping[table].get(name)
            if existing is not None and existing is not target:
                raise KeyError(
                    f"Name '{name}' already registered for {existing} in {table}"
                )
            cls.mapping[table][name] = target
            return target

        return wrap

    @classmethod
    def register_builder(cls, name: str):
        return cls._register("builder_name_mapping", name)

    @classmethod
    def register_processor(cls, name: str):
        return cls._register("processor_name_mapping", name)

    @classmethod
    def register_model(cls, name: str):
        return cls._register("model_name_mapping", name)

    @classmethod
    def register_agent(cls, name: str):
        return cls._register("agent_name_mapping", name)

    @classmethod
    def register_lr_scheduler(cls, name: str):
        return cls._register("lr_scheduler_name_mapping", name)

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------
    @classmethod
    def get_builder_class(cls, name: str):
        return cls.mapping["builder_name_mapping"].get(name)

    @classmethod
    def get_processor_class(cls, name: str):
        return cls.mapping["processor_name_mapping"].get(name)

    @classmethod
    def get_model_class(cls, name: str):
        return cls.mapping["model_name_mapping"].get(name)

    @classmethod
    def get_agent_class(cls, name: str):
        return cls.mapping["agent_name_mapping"].get(name)

    @classmethod
    def get_lr_scheduler_class(cls, name: str):
        return cls.mapping["lr_scheduler_name_mapping"].get(name)

    @classmethod
    def list_builders(cls):
        return sorted(cls.mapping["builder_name_mapping"].keys())

    @classmethod
    def list_processors(cls):
        return sorted(cls.mapping["processor_name_mapping"].keys())

    @classmethod
    def list_models(cls):
        return sorted(cls.mapping["model_name_mapping"].keys())

    @classmethod
    def list_agents(cls):
        return sorted(cls.mapping["agent_name_mapping"].keys())

    # ------------------------------------------------------------------
    # paths
    # ------------------------------------------------------------------
    @classmethod
    def register_path(cls, name: str, path: str) -> None:
        cls.mapping["paths"][name] = path

    @classmethod
    def get_path(cls, name: str, default: Any = None):
        return cls.mapping["paths"].get(name, default)

    # ------------------------------------------------------------------
    # dotted-key state store (logger, configuration, ... live here)
    # ------------------------------------------------------------------
    @classmethod
    def register(cls, name: str, obj: Any) -> None:
        """Store ``obj`` under dotted key ``name`` (e.g. ``a.b.c``)."""
        path = name.split(".")
        current = cls.mapping["state"]
        for part in path[:-1]:
            current = current.setdefault(part, {})
        current[path[-1]] = obj

    @classmethod
    def get(cls, name: str, default: Any = None, no_warning: bool = True):
        path = name.split(".")
        value: Any = cls.mapping["state"]
        for part in path:
            if not isinstance(value, dict) or part not in value:
                return default
            value = value[part]
        return value

    @classmethod
    def unregister(cls, name: str):
        return cls.mapping["state"].pop(name, None)

    # the JAX package's accessor name for the live Config
    @classmethod
    def get_configuration_class(cls, name: str):
        return cls.get(name)


registry = Registry

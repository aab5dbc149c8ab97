"""The KND model's runtime pieces the port's trainer needs: the NRI event
bus and the driver base class."""

from .drivers import KNDDriver
from .nri import Event, EventBus, Events, HookResult

__all__ = ["Event", "EventBus", "Events", "HookResult", "KNDDriver"]

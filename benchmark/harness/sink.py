"""The OD4 session the service publishes into during a run."""

from __future__ import annotations

import time


class Sink:
    """Stamps each Geolocation on the host clock as the service sends it and
    keeps its fields; other messages (the map's chunks) are counted."""

    def __init__(self):
        self.geolocations: list = []   # (perf_counter seconds, lat, lon, alt, heading)
        self.other = 0

    def send(self, message, timestamp=None) -> None:
        if type(message).__name__ == "Geolocation":
            self.geolocations.append((time.perf_counter(), message.latitude,
                                      message.longitude, message.altitude, message.heading))
        else:
            self.other += 1

    def is_running(self) -> bool:
        return True

    def close(self) -> None:
        pass

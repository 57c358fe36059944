"""WGS84 <-> local Cartesian conversion.

Parity with the header-only WGS84toCartesian the reference vendors
(reference: include/WGS84toCartesian.hpp; used by Selflocalization::sendPose,
reference: src/selflocalization.cpp:301-328 to convert the SLAM Cartesian
position into a Geolocation message around a reference coordinate).
Implements the same small-angle approximation family (accurate to centimetres
within ~tens of km of the reference point).
"""

from __future__ import annotations

import math

_EQUATOR_RADIUS = 6378137.0
_FLATTENING = 1.0 / 298.257223563
_SQUARED_ECCENTRICITY = 2.0 * _FLATTENING - _FLATTENING * _FLATTENING


def _radii(latitude_rad: float):
    s = math.sin(latitude_rad)
    denom = math.sqrt(1.0 - _SQUARED_ECCENTRICITY * s * s)
    # meridional and prime-vertical radii of curvature
    m = _EQUATOR_RADIUS * (1.0 - _SQUARED_ECCENTRICITY) / denom ** 3
    n = _EQUATOR_RADIUS / denom
    return m, n


def to_cartesian(reference: tuple[float, float],
                 wgs84_position: tuple[float, float]) -> tuple[float, float]:
    """(lat, lon) -> local (x east, y north) metres around ``reference``."""
    ref_lat = math.radians(reference[0])
    m, n = _radii(ref_lat)
    d_lat = math.radians(wgs84_position[0] - reference[0])
    d_lon = math.radians(wgs84_position[1] - reference[1])
    y = d_lat * m
    x = d_lon * n * math.cos(ref_lat)
    return x, y


def from_cartesian(reference: tuple[float, float],
                   cartesian_position: tuple[float, float]) -> tuple[float, float]:
    """Local (x east, y north) metres -> (lat, lon) around ``reference``
    (wgs84::fromCartesian equivalent, call site reference:
    src/selflocalization.cpp:322)."""
    ref_lat = math.radians(reference[0])
    m, n = _radii(ref_lat)
    lat = reference[0] + math.degrees(cartesian_position[1] / m)
    lon = reference[1] + math.degrees(
        cartesian_position[0] / (n * math.cos(ref_lat))
    )
    return lat, lon

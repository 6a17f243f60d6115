"""Host milliseconds a whole-document read takes (program span:
whole_patch, the farm's get_patch), over the opens the text loop made in
the window."""


def read(r):
    loop = r.get("loop")
    if not loop or not loop.get("opens") or "whole_patch" not in r["phases"]:
        return None
    return r["phases"]["whole_patch"] * 1e3 / loop["opens"]

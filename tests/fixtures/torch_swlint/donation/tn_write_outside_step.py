"""TN: writing into a packed state outside the step set (the state
manager's own host-side import path)."""


def import_row(ps, local, column):
    si = ps.si.clone()
    si[:, local] = column
    ps.sf[:, local] = 0.0
    return ps.replace(si=si)

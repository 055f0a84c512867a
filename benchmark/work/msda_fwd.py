"""Work of one multi-scale deformable attention forward: value (B, V,
heads, D), sampling locations (B, Q, heads, L, P, 2), attention weights
(B, Q, heads, L, P), out (B, Q, heads * D).  Value is read whole, or as the
four D-wide corner rows of every point where those are fewer bytes; the
locations, weights and output once; 4 corners x D multiply-adds a point."""


def work(call):
    (vs, sv), _, (ls, sl), (as_, sa) = call["args"][:4]
    (outs, sout) = call["out"]
    B, V, heads, D = vs
    pts = ls[0] * ls[1] * ls[2] * ls[3] * ls[4]
    gathered = min(sv * B * V * heads * D, 4 * pts * sv * D)
    nbytes = gathered + pts * (2 * sl + sa) + sout * outs[0] * outs[1] * outs[2]
    return 8 * D * pts, nbytes, sv

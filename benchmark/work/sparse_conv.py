"""Work of the sparse convolutions: a gather conv over a rulebook, feats (V,
Cin), rulebook (Vout, K) int32, weight (K * Cin, Cout), mask (Vout,), out
(Vout, Cout), a product of 2 * Cin * Cout per live tap; and the rulebook
builders (submanifold and strided), which read each output row's
coordinates and mask and write its (Vout, K) int32 rows."""


def work(call):
    if call["fn"] == "sparse_conv":
        (fs, sf), (ns, _), (ws, sw), _ = call["args"][:4]
        (outs, sout) = call["out"]
        V, Cin = fs
        Vout, K = ns
        Cout = outs[1]
        nbytes = (sf * V * Cin + 4 * Vout * K + sw * ws[0] * ws[1] + Vout
                  + sout * Vout * Cout)
        return 2 * call["live"] * Cin * Cout, nbytes, sf
    (outs, sout) = call["out"]
    Vout, K = outs
    return 0, sout * Vout * K + 17 * Vout, 2

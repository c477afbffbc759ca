// Native procgen core of safelife_torch (a copy of the JAX package's
// safelife_tpu/procgen/native/safelife_native.cpp): simulated-annealing
// pattern synthesis, toroidal connected-component labeling, and a host CA
// step.
//
// Capability parity with the reference C extension (semantics re-derived
// from the reference's speedups_src/{gen_board,wrapped_label,
// advance_board,iset}.c), restructured as standalone C++ with its own RNG
// (the reference consumes numpy's global MT19937 stream; pattern synthesis
// needs distribution-level—not bit-level—parity, so a self-contained
// generator keeps the library dependency-free and thread-safe).
//
// Exposed via a flat extern "C" API for ctypes (no CPython API, no pybind).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <random>
#include <vector>

namespace {

// --- cell bits (wire format; must match safelife_torch.cells) ---------------
constexpr uint16_t ALIVE = 1 << 0;
constexpr uint16_t DESTRUCTIBLE = 1 << 3;
constexpr uint16_t FROZEN = 1 << 4;
constexpr uint16_t PRESERVING = 1 << 5;
constexpr uint16_t INHIBITING = 1 << 6;
constexpr uint16_t SPAWNING = 1 << 7;
constexpr uint16_t EXIT_FLAG = 1 << 8;
constexpr uint16_t COLOR_R = 1 << 9;
constexpr uint16_t COLORS = 7 << 9;

// gen mask bits (wire values shared with the Python side)
constexpr int NEW_CELL_MASK = 1;
constexpr int CAN_OSCILLATE_MASK = 2;
constexpr int INCLUDE_VIOLATIONS_MASK = 4;

// error codes
constexpr int ERR_MAX_ITER = -1;
constexpr int ERR_AREA = -3;

// The four cell types the annealer plays with, indexed by
// (alive?2:0)|(frozen?1:0):  empty, wall, life, tree.
constexpr uint16_t TYPE_CELLS[4] = {
    0, FROZEN, static_cast<uint16_t>(ALIVE | DESTRUCTIBLE),
    static_cast<uint16_t>(FROZEN | ALIVE)};

inline int type_index(uint16_t cell) {
    return ((cell & ALIVE) ? 2 : 0) | ((cell & FROZEN) ? 1 : 0);
}

// --- O(1) integer set with uniform sampling (reference iset.c) ------------
struct IndexSet {
    std::vector<int> items;
    std::vector<int> pos;  // -1 when absent

    explicit IndexSet(int capacity) : pos(capacity, -1) {}

    int size() const { return static_cast<int>(items.size()); }

    void add(int v) {
        if (pos[v] >= 0) return;
        pos[v] = size();
        items.push_back(v);
    }

    void discard(int v) {
        int p = pos[v];
        if (p < 0) return;
        int last = items.back();
        items[p] = last;
        pos[last] = p;
        items.pop_back();
        pos[v] = -1;
    }

    template <class Rng>
    int sample(Rng &rng) const {
        return items[static_cast<int>(rng.uniform() * size()) % size()];
    }
};

// --- RNG -------------------------------------------------------------------
struct Rng {
    std::mt19937_64 gen;
    explicit Rng(uint64_t seed) : gen(seed) {}
    double uniform() {
        return std::generate_canonical<double, 53>(gen);
    }
};

// --- torus helpers -----------------------------------------------------------
struct Shape {
    int depth, rows, cols;
    int layer() const { return rows * cols; }
    int wrap_row(int r) const { return ((r % rows) + rows) % rows; }
    int wrap_col(int c) const { return ((c % cols) + cols) % cols; }
    int at(int layer_i, int r, int c) const {
        return wrap_col(c) + (wrap_row(r) + layer_i * rows) * cols;
    }
};

}  // namespace

// ===========================================================================
// CA step (host; used to fill the annealer's period stack and for procgen
// stability checks).  Deterministic when spawn_prob == 0.
// ===========================================================================
extern "C" void slt_advance_board(
        const uint16_t *src, uint16_t *dst, int rows, int cols,
        double spawn_prob, uint64_t rng_seed) {
    const int n = rows * cols;
    std::vector<int> count(n, 0), color_w(n, 0), flags(n, 0), destr_w(n, 0);
    Shape s{1, rows, cols};
    Rng rng(rng_seed);

    std::vector<int> cr(n, 0), cg(n, 0), cb(n, 0);
    for (int r = 0; r < rows; r++) {
        for (int c = 0; c < cols; c++) {
            int i = r * cols + c;
            uint16_t cell = src[i];
            int alive = cell & ALIVE;
            int spawning = (cell & SPAWNING) ? 1 : 0;
            int cw = alive + 2 * spawning;
            int dw = ((cell & (DESTRUCTIBLE | EXIT_FLAG)) ? 1 : 0) * alive;
            for (int dr = -1; dr <= 1; dr++) {
                for (int dc = -1; dc <= 1; dc++) {
                    int j = s.at(0, r + dr, c + dc);
                    count[j] += alive;
                    flags[j] |= cell;
                    destr_w[j] += dw;
                    if (cell & COLOR_R) cr[j] += cw;
                    if (cell & (COLOR_R << 1)) cg[j] += cw;
                    if (cell & (COLOR_R << 2)) cb[j] += cw;
                }
            }
        }
    }
    for (int i = 0; i < n; i++) {
        uint16_t cell = src[i];
        bool frozen = cell & FROZEN;
        bool preserved = flags[i] & PRESERVING;
        bool inhibited = flags[i] & INHIBITING;
        bool near_spawner = flags[i] & SPAWNING;
        uint16_t inherit = 0;
        if (cr[i] >= 2) inherit |= COLOR_R;
        if (cg[i] >= 2) inherit |= COLOR_R << 1;
        if (cb[i] >= 2) inherit |= COLOR_R << 2;
        if (cell & ALIVE) {
            bool survives = frozen || preserved ||
                count[i] == 3 || count[i] == 4;
            dst[i] = survives ? cell : 0;
        } else if (!frozen && !inhibited && count[i] == 3) {
            dst[i] = ALIVE | inherit |
                (destr_w[i] >= 2 ? DESTRUCTIBLE : 0);
        } else if (!frozen && !inhibited && near_spawner &&
                   rng.uniform() < spawn_prob) {
            dst[i] = ALIVE | DESTRUCTIBLE | inherit;
        } else {
            dst[i] = cell;
        }
    }
}

// ===========================================================================
// Toroidal 8-connected component labeling (reference wrapped_label.c).
// data: nonzero = foreground, labels written in place; returns num labels.
// ===========================================================================
extern "C" int slt_wrapped_label(int32_t *data, int rows, int cols) {
    const int n = rows * cols;
    Shape s{1, rows, cols};
    std::vector<int32_t> out(n, 0);
    std::vector<int> stack;
    int next_label = 0;
    for (int i = 0; i < n; i++) {
        if (!data[i] || out[i]) continue;
        next_label++;
        out[i] = next_label;
        stack.push_back(i);
        while (!stack.empty()) {
            int j = stack.back();
            stack.pop_back();
            int r = j / cols, c = j % cols;
            for (int dr = -1; dr <= 1; dr++) {
                for (int dc = -1; dc <= 1; dc++) {
                    int k = s.at(0, r + dr, c + dc);
                    if (data[k] && !out[k]) {
                        out[k] = next_label;
                        stack.push_back(k);
                    }
                }
            }
        }
    }
    std::memcpy(data, out.data(), n * sizeof(int32_t));
    return next_label;
}

// ===========================================================================
// Simulated-annealing pattern synthesis (reference gen_board.c).
// ===========================================================================
namespace {

struct Annealer {
    Shape shape;
    uint16_t *board;          // (depth, rows, cols) — layer 0 is "now"
    const int32_t *mask;      // (rows, cols) gen-mask bits
    std::vector<int> neighbors;      // per-layer self-inclusive alive counts
    std::vector<int> violations;     // per-cell (layer 0)
    std::vector<int> oscillations;   // per-cell bitmask: ALIVE*(1=dead seen,
                                     //                    2=alive seen)
    IndexSet bad, unmasked, seeds;
    int totals[4] = {0, 0, 0, 0};
    int total_area = 0;

    Annealer(uint16_t *board_, const int32_t *mask_, const int32_t *seeds_,
             Shape shape_)
        : shape(shape_), board(board_), mask(mask_),
          neighbors(shape_.depth * shape_.layer(), 0),
          violations(shape_.layer(), 0), oscillations(shape_.layer(), 0),
          bad(shape_.layer()), unmasked(shape_.layer()),
          seeds(shape_.layer()) {
        const int layer = shape.layer();
        // Self-inclusive 3x3 alive counts per layer.
        for (int li = 0; li < shape.depth; li++) {
            for (int r = 0; r < shape.rows; r++) {
                for (int c = 0; c < shape.cols; c++) {
                    int alive = board[shape.at(li, r, c)] & ALIVE;
                    if (!alive) continue;
                    for (int dr = -1; dr <= 1; dr++)
                        for (int dc = -1; dc <= 1; dc++)
                            neighbors[shape.at(li, r + dr, c + dc)] += 1;
                }
            }
        }
        // Oscillation masks across layers.
        for (int li = 0; li < shape.depth; li++)
            for (int k = 0; k < layer; k++)
                oscillations[k] |= (board[k + li * layer] & ALIVE) + ALIVE;
        // Initial violations: does the last layer evolve back to layer 0?
        const int last = (shape.depth - 1) * layer;
        for (int k = 0; k < layer; k++) {
            violations[k] = violation(board[last + k], board[k],
                                      neighbors[last + k]);
            if (seeds_ && seeds_[k]) seeds.add(k);
            if (violations[k] && (mask[k] & INCLUDE_VIOLATIONS_MASK))
                bad.add(k);
            if (mask[k] & NEW_CELL_MASK) {
                unmasked.add(k);
                total_area++;
                totals[type_index(board[k])]++;
            }
        }
    }

    static int violation(uint16_t src, uint16_t dst, int nb) {
        if (src & FROZEN) return src != dst;
        if (src & ALIVE) return ((nb == 3 || nb == 4) ? 1 : 0) ^
            ((dst & ALIVE) ? 1 : 0);
        return ((nb == 3) ? 1 : 0) ^ ((dst & ALIVE) ? 1 : 0);
    }

    // Replace the cell at (layer, r, c); keep neighbor counts incremental.
    // Returns 0 = unchanged, 1 = frozen-only change, 2 = alive flipped.
    int put_cell(int li, int r, int c, uint16_t cell) {
        int i0 = shape.at(li, r, c);
        uint16_t old = board[i0];
        if (old == cell) return 0;
        board[i0] = cell;
        int delta = (cell & ALIVE) - (old & ALIVE);
        if (!delta) return 1;
        for (int dr = -1; dr <= 1; dr++)
            for (int dc = -1; dc <= 1; dc++)
                neighbors[shape.at(li, r + dr, c + dc)] += delta;
        return 2;
    }

    struct Delta {
        int violations = 0;
        int oscillations = 0;
    };

    // Swap the layer-0 cell at (r, c) to `cell`, ripple the change through
    // the period stack, and update violation/oscillation bookkeeping.
    Delta swap(int r, int c, uint16_t cell, bool track_bad) {
        Delta out;
        int x1 = c, y1 = r, x2 = c, y2 = r;
        int did = put_cell(0, r, c, cell);
        if (did == 0) return out;
        if (did == 2) { x1--; y1--; x2++; y2++; }

        for (int li = 1; li < shape.depth; li++) {
            int any = 0;
            for (int rr = y1; rr <= y2; rr++) {
                for (int cc = x1; cc <= x2; cc++) {
                    int i1 = shape.at(li - 1, rr, cc);
                    uint16_t b1 = board[i1], b2;
                    int n1 = neighbors[i1];
                    if (b1 & FROZEN) b2 = b1;
                    else if (b1 & ALIVE) b2 = (n1 == 3 || n1 == 4) ? b1 : 0;
                    else b2 = (n1 == 3) ? ALIVE : b1;
                    int d = put_cell(li, rr, cc, b2);
                    any |= d;
                    if (d) {
                        if (cc == x1) x1--;
                        if (cc == x2) x2++;
                        if (rr == y1) y1--;
                        if (rr == y2) y2++;
                    }
                }
            }
            if (!any) break;
        }

        const int layer = shape.layer();
        const int is_osc = 3 * ALIVE;
        for (int rr = y1; rr <= y2; rr++) {
            for (int cc = x1; cc <= x2; cc++) {
                int i1 = shape.at(0, rr, cc);
                int v, osc;
                uint16_t b1 = board[i1];
                if (b1 & FROZEN) {
                    v = 0;
                    osc = 0;
                } else {
                    osc = (b1 & ALIVE) + ALIVE;
                    int i2 = i1;
                    uint16_t b2 = b1;
                    for (int li = 1; li < shape.depth; li++) {
                        i2 += layer;
                        b2 = board[i2];
                        osc |= (b2 & ALIVE) + ALIVE;
                    }
                    v = violation(b2, b1, neighbors[i2]);
                }
                if (osc == is_osc && !(mask[i1] & CAN_OSCILLATE_MASK)) v += 1;
                out.violations += v - violations[i1];
                out.oscillations += (osc == is_osc) -
                    (oscillations[i1] == is_osc);
                violations[i1] = v;
                oscillations[i1] = osc;
                if (track_bad) {
                    if (v && (mask[i1] & INCLUDE_VIOLATIONS_MASK))
                        bad.add(i1);
                    else
                        bad.discard(i1);
                }
            }
        }
        return out;
    }
};

}  // namespace

extern "C" int slt_gen_pattern(
        uint16_t *board_stack,   // (period, rows, cols) in/out; layer 0 is
                                 // the result
        const int32_t *mask,     // (rows, cols) gen-mask bits
        const int32_t *seeds,    // (rows, cols) or nullptr
        int period, int rows, int cols,
        double rel_max_iter, double rel_min_fill, double temperature,
        double osc_bonus,
        const double *cell_penalties,  // 8 doubles: (base, slope) x
                                       // empty/wall/life/tree
        uint64_t rng_seed) {
    Shape shape{period, rows, cols};
    Annealer ann(board_stack, mask, seeds, shape);
    Rng rng(rng_seed);

    if (ann.total_area <= 0) return ERR_AREA;

    const long max_iter =
        static_cast<long>(rel_max_iter * ann.total_area * period);
    const double min_fill = rel_min_fill * ann.total_area;
    const double beta = 1.0 / temperature;
    const int nb_span = 2 * period + 1;
    const int max_props = 3 * nb_span * nb_span;
    std::vector<double> log_probs(max_props);
    std::vector<uint16_t> prop_cells(max_props);
    std::vector<int> prop_idx(max_props);

    long it = 0;
    for (; it < max_iter; it++) {
        int not_empty = ann.total_area - ann.totals[0];
        if (ann.bad.size() == 0 && not_empty >= min_fill) break;  // success

        int k0 = (ann.bad.size() > 0) ? ann.bad.sample(rng)
                 : (ann.seeds.size() > 0) ? ann.seeds.sample(rng)
                 : ann.unmasked.sample(rng);
        ann.seeds.discard(k0);  // each seed is used at most once
        int r0 = k0 / cols, c0 = k0 % cols;

        // Density-dependent cell-type penalties.
        double penalties[4];
        {
            double t = min_fill > 0 ? not_empty / min_fill : 2.0;
            penalties[0] = t < 0.9 ? 2.0 : (t < 1.0 ? 20 * (1 - t) : 0.0);
        }
        for (int j = 1; j < 4; j++) {
            double t = ann.totals[j] / (not_empty + 1.0);
            penalties[j] = cell_penalties[2 * j] + t * cell_penalties[2 * j + 1];
        }

        // Propose the 3 alternative types for every unmasked cell in the
        // extended neighborhood; deltas accumulate so each entry is the
        // change relative to the CURRENT board.
        int num_props = 0;
        double max_lp = -1e300;
        for (int r = r0 - period; r <= r0 + period; r++) {
            for (int c = c0 - period; c <= c0 + period; c++) {
                int i1 = shape.at(0, r, c);
                if (!(mask[i1] & NEW_CELL_MASK)) continue;
                uint16_t current = board_stack[i1];
                int start = type_index(current) + 1;
                int dv = 0, dosc = 0;
                for (int j = start; j < start + 3; j++) {
                    uint16_t target = TYPE_CELLS[j & 3];
                    Annealer::Delta d = ann.swap(r, c, target, false);
                    dv += d.violations;
                    dosc += d.oscillations;
                    double lp = -beta * (dv - osc_bonus * dosc +
                                         penalties[j & 3]);
                    log_probs[num_props] = lp;
                    prop_cells[num_props] = target;
                    prop_idx[num_props] = i1;
                    if (lp > max_lp) max_lp = lp;
                    num_props++;
                }
                ann.swap(r, c, current, false);  // restore
            }
        }

        // Boltzmann-sample one proposal.
        double total = 0.0;
        for (int k = 0; k < num_props; k++) {
            total += std::exp(log_probs[k] - max_lp);
            log_probs[k] = total;  // now cumulative
        }
        double target_p = rng.uniform() * total;
        for (int k = 0; k < num_props; k++) {
            if (log_probs[k] > target_p) {
                int idx = prop_idx[k];
                uint16_t old_cell = board_stack[idx];
                ann.swap(idx / cols, idx % cols, prop_cells[k], true);
                ann.totals[type_index(old_cell)]--;
                ann.totals[type_index(prop_cells[k])]++;
                break;
            }
        }
    }
    return it >= max_iter ? ERR_MAX_ITER : 0;
}

extern "C" int slt_version() { return 1; }

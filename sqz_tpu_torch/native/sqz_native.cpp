// tpu-sqz native host runtime: both codecs (FORMAT.md §1-§2), exact
// hash-chain LZ77 matcher, and a threaded block executor for the sqzt
// container (FORMAT.md §3). C ABI, bound from Python via ctypes.
//
// This is a from-scratch C++ implementation of the wire formats specified in
// FORMAT.md (behavior pinned to reference attic/map_experiment/*.h and
// src/sqz.c — see the file:line cites there); it shares no code with the
// reference. Differential tests in tests/test_native.py enforce byte
// identity against the Python oracle and the compiled reference.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMask64 = ~0ull;

// ------------------------------------------------------------------ errors

struct CodecError {
    int err;
};

[[noreturn]] void fail(int err) { throw CodecError{err}; }

// --------------------------------------------------------------- bitstream

// FORMAT.md §1.1: 64-bit shift register, big-endian word flush, multi-bit
// values LSB-first.
class BitWriter {
  public:
    BitWriter(uint8_t* out, uint64_t cap) : out_(out), cap_(cap) {}

    void write_bit(uint32_t bit) {
        b64_ = (b64_ << 1) | (bit & 1u);
        if (++nbits_ == 64) flush_word();
    }

    void write_bits(uint64_t value, int nbits) {
        for (int i = 0; i < nbits; i++) {
            write_bit(static_cast<uint32_t>(value & 1u));
            value >>= 1;
        }
    }

    void flush() {
        while (nbits_ != 0) write_bit(0);
    }

    uint64_t bytes() const { return len_; }

  private:
    void flush_word() {
        if (len_ + 8 > cap_) fail(ENOBUFS);
        for (int i = 7; i >= 0; i--) out_[len_++] = static_cast<uint8_t>(b64_ >> (8 * i));
        b64_ = 0;
        nbits_ = 0;
    }

    uint8_t* out_;
    uint64_t cap_;
    uint64_t len_ = 0;
    uint64_t b64_ = 0;
    int nbits_ = 0;
};

// Records bitstream writes for the TPU bit-packer kernel: one u32 per
// write, nbits in bits 29..25, the nbits-bit value BIT-REVERSED in bits
// 24..0 (the packer appends stream-order-first-bit-at-the-top chunks;
// BitWriter emits values LSB-first). Writes over 24 bits split.
class WriteRecorder {
  public:
    explicit WriteRecorder(std::vector<uint32_t>& out) : out_(&out) {}

    void write_bit(uint32_t bit) { write_bits(bit & 1u, 1); }

    void write_bits(uint64_t value, int nbits) {
        while (nbits > 24) {
            write_bits(value & 0xFFFFFF, 24);
            value >>= 24;
            nbits -= 24;
        }
        if (nbits == 0) return;
        uint32_t rev = 0;
        for (int i = 0; i < nbits; i++) {
            rev = (rev << 1) | (static_cast<uint32_t>(value >> i) & 1u);
        }
        out_->push_back((static_cast<uint32_t>(nbits) << 25) | rev);
        bits_ += static_cast<uint64_t>(nbits);
    }

    void flush() {}  // the packer pads the final 64-bit word itself

    uint64_t bits() const { return bits_; }

  private:
    std::vector<uint32_t>* out_;
    uint64_t bits_ = 0;
};

class BitReader {
  public:
    BitReader(const uint8_t* data, uint64_t n) : data_(data), n_(n) {}

    uint32_t read_bit() {
        if (nbits_ == 0) {
            if (pos_ + 8 > n_) fail(EILSEQ);
            load();
        }
        uint32_t bit = static_cast<uint32_t>(b64_ >> 63);
        b64_ <<= 1;
        nbits_--;
        return bit;
    }

    uint64_t read_bits(int nbits) {
        if (nbits > 0 && nbits <= 16) {  // hot: extra bits / NYT (<= 13)
            uint32_t p = peek(nbits);
            consume(nbits);
            // stream emits the value LSB-first, so the MSB-first peek is
            // the bit-reversed value
            uint64_t v = 0;
            for (int i = 0; i < nbits; i++) v |= ((p >> (nbits - 1 - i)) & 1u) << i;
            return v;
        }
        uint64_t v = 0;
        for (int i = 0; i < nbits; i++) v |= static_cast<uint64_t>(read_bit()) << i;
        return v;
    }

    // ---- LUT-decoder fast path: MSB-first peek without consuming. Bits
    // past the real stream read as zeros; consume() raises the same EILSEQ
    // the bit-serial reader would, exactly when virtual bits are consumed.
    uint32_t peek(int k) const {
        uint64_t w = b64_;
        if (nbits_ < k && pos_ + 8 <= n_) {
            const uint64_t nxt = load_be(pos_);
            if (nbits_ > 0) w |= nxt >> nbits_;
            else w = nxt;
        }
        return static_cast<uint32_t>(w >> (64 - k));
    }

    void consume(int k) {
        if (k <= nbits_) {
            b64_ <<= k;
            nbits_ -= k;
            return;
        }
        const int need = k - nbits_;
        if (pos_ + 8 > n_) fail(EILSEQ);
        load();
        b64_ <<= need;
        nbits_ -= need;
    }

  private:
    uint64_t load_be(uint64_t at) const {
        uint64_t w;
        std::memcpy(&w, data_ + at, 8);
        return __builtin_bswap64(w);   // streams are big-endian 64-bit words
    }

    void load() {
        b64_ = load_be(pos_);
        pos_ += 8;
        nbits_ = 64;
    }

    const uint8_t* data_;
    uint64_t n_;
    uint64_t pos_ = 0;
    uint64_t b64_ = 0;
    int nbits_ = 0;
};

// --------------------------------------------------- adaptive Huffman tree

// FORMAT.md §1.6. Index-based: terminals 0..n-1, internal nodes carved
// downward from 2n-3, root 2n-2. Paths stored and recomputed on
// restructure, exactly mirroring the reference state machine.
class HuffTree {
  public:
    // Hot per-node state packed into one 16-byte record so the
    // frequency cascade's parent/child hops stay within a couple of cache
    // lines (the six parallel arrays spread the same walk over ~48 KB,
    // measured as the decode bottleneck — PERF.md round 3). path/bits are
    // cold (encoder writes, LUT patches) and stay separate.
    struct Node { uint64_t freq; int16_t pix, lix, rix, pad; };

    explicit HuffTree(int terminals)
        : n_(terminals), m_(2 * terminals - 1),
          nd_(m_, Node{0, -1, -1, -1, 0}),
          path_(m_, 0), bits_(m_, 0),
          next_(m_ - 1) {}

    bool seen(int i) const { return nd_[i].pix != -1; }
    uint64_t path(int i) const { return path_[i]; }
    int bits(int i) const { return bits_[i]; }
    int root() const { return m_ - 1; }
    int left(int i) const { return nd_[i].lix; }
    int right(int i) const { return nd_[i].rix; }
    bool is_leaf(int i) const { return nd_[i].lix < 0 && nd_[i].rix < 0; }

    // LUT decode support: every tree-SHAPE event (the only events that
    // change codewords: sibling swap, move-up, leaf insert/splice) records
    // the topmost rearranged node whose own path was unchanged at that
    // moment; the decoder re-fills those LUT prefix ranges after the
    // symbol settles (see HuffLut). nullptr disables tracking.
    void track_shape(std::vector<int>* d) { dirty_ = d; }

    bool insert(int i) {
        int ipx = root();
        nd_[i].freq = 1;
        while (ipx >= n_) {
            if (nd_[ipx].rix == -1) { nd_[ipx].rix = i; nd_[i].pix = ipx; break; }
            if (nd_[ipx].lix == -1) { nd_[ipx].lix = i; nd_[i].pix = ipx; break; }
            ipx = nd_[ipx].lix;
        }
        if (ipx >= n_) {
            nd_[ipx].freq++;
            i = swap_siblings(i);
        } else {
            if (next_ == n_) { complete_ = true; return false; }
            int nix = --next_;
            nd_[nix].freq = nd_[ipx].freq;
            nd_[nix].lix = ipx;
            nd_[nix].rix = -1;
            nd_[nix].pix = nd_[ipx].pix;
            bits_[nix] = bits_[ipx];
            path_[nix] = path_[ipx];
            int opix = nd_[ipx].pix;
            if (opix != -1) {
                (nd_[opix].lix == ipx ? nd_[opix].lix : nd_[opix].rix) = nix;
            }
            nd_[ipx].pix = nix;
            bits_[ipx]++;
            path_[ipx] = path_[nix];
            nd_[nix].rix = i;
            nd_[i].pix = nix;
            bits_[i] = bits_[nix] + 1;
            path_[i] = path_[nix] | (1ull << bits_[nix]);
            update_freq(nix);
            ipx = nix;
        }
        if (dirty_) dirty_->push_back(ipx);
        frequency_changed(i);
        update_paths(ipx);
        return true;
    }

    void inc_frequency(int i) {
        if (nd_[i].pix == -1) {
            insert(i);
        } else if (!complete_ && depth_ < 63 && nd_[i].freq < kMask64 - 1) {
            nd_[i].freq++;
            frequency_changed(i);
        } else {
            complete_ = true;
        }
    }

    // sqzt v2 warm start (FORMAT.md §3.1): flat i64 state, layout shared
    // with the Python oracle — [next, depth, complete] + freq + path +
    // bits + pix + lix + rix (m entries each) = 3 + 6m words.
    int seed_words() const { return 3 + 6 * m_; }

    void dump_state(int64_t* s) const {
        s[0] = next_;
        s[1] = depth_;
        s[2] = complete_ ? 1 : 0;
        int64_t* p = s + 3;
        for (int i = 0; i < m_; i++) *p++ = static_cast<int64_t>(nd_[i].freq);
        for (int i = 0; i < m_; i++) *p++ = static_cast<int64_t>(path_[i]);
        for (int i = 0; i < m_; i++) *p++ = bits_[i];
        for (int i = 0; i < m_; i++) *p++ = nd_[i].pix;
        for (int i = 0; i < m_; i++) *p++ = nd_[i].lix;
        for (int i = 0; i < m_; i++) *p++ = nd_[i].rix;
    }

    void load_state(const int64_t* s) {
        next_ = static_cast<int>(s[0]);
        depth_ = static_cast<int>(s[1]);
        complete_ = s[2] != 0;
        const int64_t* p = s + 3;
        for (int i = 0; i < m_; i++) nd_[i].freq = static_cast<uint64_t>(*p++);
        for (int i = 0; i < m_; i++) path_[i] = static_cast<uint64_t>(*p++);
        for (int i = 0; i < m_; i++) bits_[i] = static_cast<int>(*p++);
        for (int i = 0; i < m_; i++) nd_[i].pix = static_cast<int>(*p++);
        for (int i = 0; i < m_; i++) nd_[i].lix = static_cast<int>(*p++);
        for (int i = 0; i < m_; i++) nd_[i].rix = static_cast<int>(*p++);
    }

  private:
    void update_paths(int i) {
        if (i == m_ - 1) depth_ = 0;
        const int b = bits_[i];
        const uint64_t p = path_[i];
        if (nd_[i].lix != -1) {
            bits_[nd_[i].lix] = b + 1;
            path_[nd_[i].lix] = p;
            update_paths(nd_[i].lix);
        }
        if (nd_[i].rix != -1) {
            bits_[nd_[i].rix] = b + 1;
            path_[nd_[i].rix] = p | (1ull << b);
            update_paths(nd_[i].rix);
        }
        if (b > depth_) depth_ = b;
    }

    int swap_siblings(int i) {
        if (i < m_ - 1) {
            int pix = nd_[i].pix;
            int l = nd_[pix].lix, r = nd_[pix].rix;
            if (l >= 0 && r >= 0 && nd_[l].freq > nd_[r].freq) {
                nd_[pix].lix = r;
                nd_[pix].rix = l;
                if (dirty_) dirty_->push_back(pix);
                update_paths(pix);
                return i == l ? r : l;
            }
        }
        return i;
    }

    void update_freq(int i) {
        nd_[i].freq = (nd_[i].lix >= 0 ? nd_[nd_[i].lix].freq : 0) +
                      (nd_[i].rix >= 0 ? nd_[nd_[i].rix].freq : 0);
    }

    void move_up(int ix) {
        int pix = nd_[ix].pix;
        int gix = nd_[pix].pix;
        bool parent_is_left = pix == nd_[gix].lix;
        int psx = parent_is_left ? nd_[gix].rix : nd_[gix].lix;  // uncle
        if (nd_[ix].freq > nd_[psx].freq) {
            nd_[ix].pix = gix;
            (parent_is_left ? nd_[gix].rix : nd_[gix].lix) = ix;
            nd_[pix].rix = psx;
            nd_[psx].pix = pix;
            update_freq(pix);
            update_freq(gix);
            swap_siblings(ix);
            swap_siblings(psx);
            swap_siblings(pix);
            if (dirty_) dirty_->push_back(gix);
            update_paths(gix);
            frequency_changed(gix);
        }
    }

    // Iterative form of the reference cascade (recursive original kept in
    // the comment below for auditing): ascend re-summing parents and
    // swapping out-of-order siblings, then unwind top-down applying the
    // move-up checks — the same pre/post order the recursion produced.
    // This is the hottest loop in the host codec (gprof: 41% of a
    // compress+decompress run before flattening); the resum + swap
    // compare share their two freq loads per level.
    //
    //   void frequency_changed(int i) {          // original (reference
    //       int pix = pix_[i];                   //  huffman.h state machine)
    //       if (pix == -1) { update_freq(i); i = swap_siblings(i); }
    //       else { update_freq(pix); i = swap_siblings(i);
    //              frequency_changed(pix); }
    //       if (pix != -1 && pix_[pix] != -1 && i == rix_[pix]) move_up(i);
    //   }
    void frequency_changed(int i) {
        int cand[80];
        int sp = 0;
        for (;;) {
            const int pix = nd_[i].pix;
            if (pix == -1) {
                update_freq(i);
                swap_siblings(i);        // no-op for the root; kept 1:1
                break;
            }
            const int l = nd_[pix].lix, r = nd_[pix].rix;
            const uint64_t fl = l >= 0 ? nd_[l].freq : 0;
            const uint64_t fr = r >= 0 ? nd_[r].freq : 0;
            nd_[pix].freq = fl + fr;     // update_freq(pix)
            int i2 = i;
            int rcur = r;
            if (l >= 0 && r >= 0 && fl > fr) {   // swap_siblings(i)
                nd_[pix].lix = r;
                nd_[pix].rix = l;
                rcur = l;
                if (dirty_) dirty_->push_back(pix);
                update_paths(pix);
                i2 = (i == l) ? r : l;
            }
            // move-up candidates: right children of non-root parents. The
            // unwind re-verifies against current state (upper move-ups
            // re-enter this function and can rearrange), matching the
            // recursive original's post-order evaluation exactly.
            if (i2 == rcur && nd_[pix].pix != -1) cand[sp++] = i2;
            i = pix;
        }
        while (sp > 0) {
            const int j = cand[--sp];
            const int pj = nd_[j].pix;
            if (pj != -1 && nd_[pj].pix != -1 && j == nd_[pj].rix) move_up(j);
        }
    }

    int n_, m_;
    std::vector<Node> nd_;
    std::vector<uint64_t> path_;
    std::vector<int> bits_;
    int next_;
    int depth_ = 0;
    bool complete_ = false;
    std::vector<int>* dirty_ = nullptr;
};

// Prefix decode LUT over a HuffTree (VERDICT r2 #4): 2^K entries indexed
// by the next K stream bits (MSB-first). A leaf within K bits resolves in
// one lookup; longer codes continue the bit-serial walk from the stored
// depth-K boundary node. Codeword changes are rare (measured 0.077 shape
// events/symbol, PERF.md), and each event re-fills only the recorded
// subtree's prefix range, so the rebuild amortizes to a few entry writes
// per symbol instead of 2^K.
struct HuffLut {
    static constexpr int K = 10;       // 2 KiB table: stays L1-resident next
    static constexpr uint32_t kLeaf = 0x8000u;    // to the packed tree nodes
    static constexpr uint32_t kInvalid = 0x4000u; // walk hit a -1 child
    std::vector<uint16_t> e;

    explicit HuffLut(const HuffTree& t) : e(size_t(1) << K) { patch(t, t.root()); }

    // u16 entry: kLeaf | len<<10 | node (node <= 1022, len <= K)
    //            boundary (internal at depth K) -> plain node index
    void fill(const HuffTree& t, int node, uint32_t prefix, int depth) {
        if (t.is_leaf(node) || depth == K) {
            const uint16_t entry = t.is_leaf(node)
                ? static_cast<uint16_t>(kLeaf
                      | (static_cast<uint32_t>(depth) << 10)
                      | static_cast<uint32_t>(node))
                : static_cast<uint16_t>(node);
            const uint32_t lo = prefix << (K - depth);
            const uint32_t cnt = 1u << (K - depth);
            for (uint32_t j = 0; j < cnt; j++) e[lo + j] = entry;
            return;
        }
        for (int b = 0; b < 2; b++) {
            const int c = b ? t.right(node) : t.left(node);
            const uint32_t p = (prefix << 1) | static_cast<uint32_t>(b);
            if (c >= 0) {
                fill(t, c, p, depth + 1);
            } else {  // growing tree: unreachable side decodes as EILSEQ
                const uint32_t lo = p << (K - depth - 1);
                const uint32_t cnt = 1u << (K - depth - 1);
                for (uint32_t j = 0; j < cnt; j++)
                    e[lo + j] = static_cast<uint16_t>(kInvalid);
            }
        }
    }

    void patch(const HuffTree& t, int node) {
        const int d = t.bits(node);
        if (node != t.root() && d == 0) return;  // detached (stale record)
        if (d > K) return;        // deep subtrees never own LUT entries
        // prefix = the walk bits to `node`: path bit k = step at depth k
        uint32_t prefix = 0;
        const uint64_t p = t.path(node);
        for (int k = 0; k < d; k++) prefix = (prefix << 1) | ((p >> k) & 1);
        fill(t, node, prefix, d);
    }
};

// ------------------------------------------------------ DEFLATE-like tables

// FORMAT.md §1.4 (values per reference squeeze.h:29-79).
constexpr uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLenXb[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kPosBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
    8193, 12289, 16385, 24577};
constexpr uint8_t kPosXb[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

constexpr int kLitNyt = 285, kPosNyt = 30, kSymMin = 257;
constexpr int kSqueezeLenMin = 3, kSqueezeLenMax = 257;

struct DeflateIndex {
    uint8_t len_index[285];
    uint8_t pos_index[1u << 15];

    DeflateIndex() {
        int j = 0;
        int boundary = kLenBase[0] + (1 << kLenXb[0]);
        std::memset(len_index, 0, sizeof(len_index));
        for (int len = 3; len < 285; len++) {
            if (len == boundary) {
                j++;
                boundary = kLenBase[j] + (1 << kLenXb[j]);
            }
            len_index[len] = static_cast<uint8_t>(j);
        }
        j = 0;
        boundary = kPosBase[0] + (1 << kPosXb[0]);
        for (int d = 0; d < (1 << 15); d++) {
            if (d == boundary) {
                j++;
                boundary = kPosBase[j] + (1 << kPosXb[j]);
            }
            pos_index[d] = static_cast<uint8_t>(j);
        }
    }
};

const DeflateIndex kIndex;

// -------------------------------------------------- exact LZ77 match finder

// FORMAT.md §1.5: longest match over [i-window+1, i-1], length capped at
// min(max_len, n-i), smallest distance on ties. Hash chains keyed by the
// min_len-gram (verified exactly), walked nearest-first — result-equivalent
// to the reference's brute-force backward scan.
// Pointwise match extension with 8-byte word compares: identical result
// to the byte loop (it is a comparison, not a copy, so overlapping
// cand/cur at small distances are fine), ~8x fewer iterations on long
// matches. Reads stay in bounds: callers pass cap <= n - (cur - data)
// and cand < cur.
static inline uint32_t extend_match(const uint8_t* cand, const uint8_t* cur,
                                    uint32_t k, uint32_t cap) {
    while (k + 8 <= cap) {
        uint64_t x, y;
        std::memcpy(&x, cand + k, 8);
        std::memcpy(&y, cur + k, 8);
        uint64_t d = x ^ y;
        if (d != 0) {
#if (defined(__GNUC__) || defined(__clang__)) && \
    defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
            // little-endian: first differing byte = lowest set byte
            return k + (static_cast<uint32_t>(__builtin_ctzll(d)) >> 3);
#else
            break;  // finish with the byte loop below
#endif
        }
        k += 8;
    }
    while (k < cap && cand[k] == cur[k]) k++;
    return k;
}

class MatchFinder {
  public:
    MatchFinder(const uint8_t* data, uint64_t n, uint32_t window,
                int min_len, int max_len)
        : data_(data), n_(n), window_(window),
          min_len_(min_len), max_len_(max_len),
          head_(kTableSize, -1),
          prev_(n > 0 ? n : 1, -1) {}

    // Insert position p into its gram chain (call for every p in order).
    void insert(uint64_t p) {
        if (p + static_cast<uint64_t>(min_len_) <= n_) {
            uint32_t h = hash(p);
            prev_[p] = head_[h];
            head_[h] = static_cast<int64_t>(p);
        }
    }

    void find(uint64_t i, uint32_t* out_len, uint32_t* out_dist) const {
        *out_len = 0;
        *out_dist = 0;
        uint64_t cap64 = n_ - i;
        uint32_t cap = cap64 < static_cast<uint64_t>(max_len_)
                           ? static_cast<uint32_t>(cap64)
                           : static_cast<uint32_t>(max_len_);
        if (cap < static_cast<uint32_t>(min_len_)) return;
        int64_t lo = static_cast<int64_t>(i) - window_ + 1;
        if (lo < 0) lo = 0;
        uint32_t best = 0;
        const uint8_t* cur = data_ + i;
        for (int64_t j = head_[hash(i)]; j >= lo; j = prev_[j]) {
            const uint8_t* cand = data_ + j;
            // a strictly longer match must also agree at offset `best`
            // (positions 0..best must all match) — one byte-compare
            // rejects most chain candidates before the full extend,
            // without changing any decision (j+best < i+best <= n)
            if (best != 0 && cand[best] != cur[best]) continue;
            // exact gram verification (the chain is keyed by a hash)
            if (std::memcmp(cand, cur, static_cast<size_t>(min_len_)) != 0) continue;
            uint32_t k = extend_match(cand, cur,
                                      static_cast<uint32_t>(min_len_), cap);
            if (k > best) {
                best = k;
                *out_dist = static_cast<uint32_t>(i - j);
                if (k == cap) break;  // cannot be strictly beaten
            }
        }
        *out_len = best;
    }

  private:
    static constexpr uint32_t kTableBits = 17;
    static constexpr uint32_t kTableSize = 1u << kTableBits;

    uint32_t hash(uint64_t p) const {
        uint32_t g = data_[p];
        for (int k = 1; k < min_len_; k++) g = (g << 8) | data_[p + k];
        return (g * 2654435761u) >> (32 - kTableBits);
    }

    const uint8_t* data_;
    uint64_t n_;
    uint32_t window_;
    int min_len_, max_len_;
    std::vector<int64_t> head_;
    std::vector<int64_t> prev_;
};

// --------------------------------------------- fast approximate match finder

// Throughput-first matcher for the sqzt TPU pipeline (VERDICT r2 #1): the
// container contract there is round-trip + ratio, not decision parity with
// the reference scan, so the search is bounded:
//   * distances 1..7 are scanned exactly (the only admissible distances for
//     short matches under the sqz4 reject rule, formats/constants.py) —
//     this also catches RLE runs at full length;
//   * distances 8..window-1 come from 4-gram hash chains walked at most
//     `depth` links, nearest-first (longest wins, nearest wins ties among
//     the visited candidates).
// Every reported match is verified byte-for-byte by the extension loop, so
// approximation affects WHICH match is found, never stream validity.
class FastMatchFinder {
  public:
    static constexpr uint32_t kEmpty = 0xFFFFFFFFu;
    static constexpr uint32_t kTableBits = 15;
    static constexpr uint32_t kTableSize = 1u << kTableBits;

    FastMatchFinder(const uint8_t* data, uint64_t n, uint32_t window,
                    int max_len, int depth)
        : data_(data), n_(n), window_(window), max_len_(max_len),
          depth_(depth), head_(kTableSize, kEmpty),
          prev_(n > 0 ? n : 1) {}

    // Rebind to a new buffer without reallocating (per-block reuse). Only
    // head_ needs clearing: prev_ entries are reached through head_ alone.
    void reset(const uint8_t* data, uint64_t n) {
        data_ = data;
        n_ = n;
        std::fill(head_.begin(), head_.end(), kEmpty);
        if (prev_.size() < n) prev_.resize(n);
    }

    inline uint32_t hash(uint64_t p) const {
        uint32_t g;
        std::memcpy(&g, data_ + p, 4);
        return (g * 2654435761u) >> (32 - kTableBits);
    }

    inline void insert(uint64_t p) {
        if (p + 4 <= n_) {
            uint32_t h = hash(p);
            prev_[p] = head_[h];
            head_[h] = static_cast<uint32_t>(p);
        }
    }

    void find(uint64_t i, uint32_t* out_len, uint32_t* out_dist) const {
        *out_len = 0;
        *out_dist = 0;
        uint64_t cap64 = n_ - i;
        uint32_t cap = cap64 < static_cast<uint64_t>(max_len_)
                           ? static_cast<uint32_t>(cap64)
                           : static_cast<uint32_t>(max_len_);
        if (cap < 2) return;
        const uint8_t* cur = data_ + i;
        uint32_t best = 0, bdist = 0;
        const uint64_t dmax = i < 7 ? i : 7;
        for (uint64_t d = 1; d <= dmax; d++) {
            const uint8_t* cand = cur - d;
            if (cand[0] != cur[0] || cand[1] != cur[1]) continue;
            uint32_t k = extend_match(cand, cur, 2, cap);
            if (k > best) {
                best = k;
                bdist = static_cast<uint32_t>(d);
                if (k == cap) break;
            }
        }
        if (cap >= 4 && i + 4 <= n_ && best < cap) {
            int64_t lo = static_cast<int64_t>(i) - window_ + 1;
            if (lo < 0) lo = 0;
            int steps = depth_;
            for (uint32_t j = head_[hash(i)];
                 j != kEmpty && static_cast<int64_t>(j) >= lo && steps-- > 0;
                 j = prev_[j]) {
                const uint8_t* cand = data_ + j;
                if (best != 0 && cand[best] != cur[best]) continue;
                uint32_t k = extend_match(cand, cur, 0, cap);
                if (k > best) {
                    best = k;
                    bdist = static_cast<uint32_t>(i - j);
                    if (k == cap) break;
                }
            }
        }
        *out_len = best;
        *out_dist = bdist;
    }

  private:
    const uint8_t* data_;
    uint64_t n_;
    uint32_t window_;
    int max_len_, depth_;
    std::vector<uint32_t> head_;
    std::vector<uint32_t> prev_;
};

// --------------------------------------------------------- squeeze encoder

template <typename W>
void squeeze_write_sym(W& bw, HuffTree& t, int sym) {
    bw.write_bits(t.path(sym), t.bits(sym));
    t.inc_frequency(sym);  // strictly after emission (FORMAT.md §1.3)
}

template <typename W>
void squeeze_encode_lit(W& bw, HuffTree& lit, int sym) {
    if (!lit.seen(sym)) {
        squeeze_write_sym(bw, lit, kLitNyt);
        bw.write_bits(static_cast<uint64_t>(sym), 9);
        if (!lit.insert(sym)) fail(E2BIG);
    } else {
        squeeze_write_sym(bw, lit, sym);
    }
}

template <typename W>
void squeeze_encode_pos(W& bw, HuffTree& pos, int code) {
    if (!pos.seen(code)) {
        squeeze_write_sym(bw, pos, kPosNyt);
        bw.write_bits(static_cast<uint64_t>(code), 5);
        if (!pos.insert(code)) fail(E2BIG);
    } else {
        squeeze_write_sym(bw, pos, code);
    }
}

// Combined lit+pos tree-seed length (sqzt v2, FORMAT.md §3.1): lit first.
constexpr int kTreeSeedWords = (3 + 6 * 1023) + (3 + 6 * 63);

template <typename W>
void squeeze_encode_payload(const uint8_t* data, uint64_t n, int win_bits,
                            W& bw, const int64_t* seed = nullptr,
                            int64_t* state_out = nullptr,
                            const uint8_t* dict = nullptr,
                            uint64_t dlen = 0, int fast_depth = 0) {
    HuffTree lit(512), pos(32);
    if (seed != nullptr) {
        lit.load_state(seed);
        pos.load_state(seed + lit.seed_words());
    } else {
        lit.insert(kLitNyt);
        pos.insert(kPosNyt);
    }
    // preset history (sqzt v2, FORMAT.md §3.1) — as in sqz4_encode_payload
    const uint8_t* base = data;
    uint64_t total = n, start = 0;
    std::vector<uint8_t> buf;
    if (dlen > 0) {
        buf.reserve(dlen + n);
        buf.insert(buf.end(), dict, dict + dlen);
        buf.insert(buf.end(), data, data + n);
        base = buf.data();
        total = dlen + n;
        start = dlen;
    }
    // fast_depth > 0: bounded approximate matcher (sqzt-contract paths
    // only — §1.5's policy is normative for size parity of raw streams)
    auto run = [&](auto& mf) {
        for (uint64_t k = 0; k < start; k++) mf.insert(k);
        uint64_t i = start;
        while (i < total) {
            uint32_t len, dist;
            mf.find(i, &len, &dist);
            if (len >= kSqueezeLenMin) {
                int li = kIndex.len_index[len];
                squeeze_encode_lit(bw, lit, kSymMin + li);
                if (kLenXb[li]) bw.write_bits(len - kLenBase[li], kLenXb[li]);
                int pi = kIndex.pos_index[dist];
                squeeze_encode_pos(bw, pos, pi);
                if (kPosXb[pi]) bw.write_bits(dist - kPosBase[pi], kPosXb[pi]);
                for (uint32_t k = 0; k < len; k++) mf.insert(i + k);
                i += len;
            } else {
                squeeze_encode_lit(bw, lit, base[i]);
                mf.insert(i);
                i++;
            }
        }
    };
    if (fast_depth > 0) {
        FastMatchFinder mf(base, total, 1u << win_bits, kSqueezeLenMax,
                           fast_depth);
        run(mf);
    } else {
        MatchFinder mf(base, total, 1u << win_bits, kSqueezeLenMin,
                       kSqueezeLenMax);
        run(mf);
    }
    bw.flush();
    if (state_out != nullptr) {
        lit.dump_state(state_out);
        pos.dump_state(state_out + lit.seed_words());
    }
}

uint64_t squeeze_read_sym(BitReader& br, HuffTree& t) {
    int i = t.root();
    uint32_t bit = br.read_bit();
    for (;;) {
        i = bit ? t.right(i) : t.left(i);
        if (i < 0) fail(EILSEQ);
        if (t.is_leaf(i)) break;
        bit = br.read_bit();
    }
    t.inc_frequency(i);
    return static_cast<uint64_t>(i);
}

// LUT fast path: stale prefix ranges from the PREVIOUS symbol's shape
// events are re-filled before the peek; codes longer than K bits resume
// the bit-serial walk from the depth-K boundary node. State evolution is
// identical to squeeze_read_sym (the LUT is a read-layer only).
uint64_t squeeze_read_sym_lut(BitReader& br, HuffTree& t, HuffLut& lut,
                              std::vector<int>& dirty) {
    if (!dirty.empty()) {
        for (int r : dirty) lut.patch(t, r);
        dirty.clear();
    }
    const uint32_t en = lut.e[br.peek(HuffLut::K)];
    int i;
    if (en & HuffLut::kLeaf) {
        br.consume(static_cast<int>((en >> 10) & 0xF));
        i = static_cast<int>(en & 0x3FF);
    } else if (en & HuffLut::kInvalid) {
        fail(EILSEQ);
        return 0;
    } else {
        br.consume(HuffLut::K);
        i = static_cast<int>(en);
        uint32_t bit = br.read_bit();
        for (;;) {
            i = bit ? t.right(i) : t.left(i);
            if (i < 0) fail(EILSEQ);
            if (t.is_leaf(i)) break;
            bit = br.read_bit();
        }
    }
    t.inc_frequency(i);
    return static_cast<uint64_t>(i);
}

uint64_t squeeze_decode_payload(BitReader& br, uint8_t* out, uint64_t size,
                                const int64_t* seed = nullptr,
                                int64_t* state_out = nullptr,
                                const uint8_t* dict = nullptr,
                                uint64_t dlen = 0) {
    HuffTree lit(512), pos(32);
    if (seed != nullptr) {
        lit.load_state(seed);
        pos.load_state(seed + lit.seed_words());
    } else {
        lit.insert(kLitNyt);
        pos.insert(kPosNyt);
    }
    // prefix-LUT decode (VERDICT r2 #4); SQZ_NO_LUT=1 restores the
    // bit-serial walk for A/B and differential testing
    static const bool no_lut = std::getenv("SQZ_NO_LUT") != nullptr;
    std::vector<int> dlit;
    std::unique_ptr<HuffLut> llut;
    if (!no_lut) {
        lit.track_shape(&dlit);
        llut.reset(new HuffLut(lit));
    }
    auto read_lit = [&]() {
        return no_lut ? squeeze_read_sym(br, lit)
                      : squeeze_read_sym_lut(br, lit, *llut, dlit);
    };
    // the pos tree is tiny (63 nodes, short codes): the bit-serial walk on
    // the packed nodes beats a second LUT competing for L1
    auto read_pos = [&]() { return squeeze_read_sym(br, pos); };
    std::vector<uint8_t> histbuf;
    uint8_t* o = out;
    if (dlen > 0) {
        histbuf.resize(dlen + size);
        std::memcpy(histbuf.data(), dict, dlen);
        o = histbuf.data() + dlen;
    }
    uint64_t i = 0;
    while (i < size) {
        uint64_t sym = read_lit();
        if (sym == kLitNyt) {
            sym = br.read_bits(9);
            // an escape naming an already-present symbol is malformed
            // (the encoder escapes unseen symbols only); insert() on a
            // linked node would corrupt the tree
            if (sym >= 512 || lit.seen(static_cast<int>(sym))
                || !lit.insert(static_cast<int>(sym))) fail(EILSEQ);
        }
        if (sym <= 0xFF) {
            o[i++] = static_cast<uint8_t>(sym);
        } else {
            if (sym < kSymMin || sym >= kLitNyt) fail(EILSEQ);
            int li = static_cast<int>(sym) - kSymMin;
            uint32_t len = kLenBase[li];
            if (kLenXb[li]) len += static_cast<uint32_t>(br.read_bits(kLenXb[li]));
            uint64_t pi = read_pos();
            if (pi == kPosNyt) {
                pi = br.read_bits(5);
                if (pi >= 30 || pos.seen(static_cast<int>(pi))
                    || !pos.insert(static_cast<int>(pi))) fail(EILSEQ);
            }
            if (pi >= 30) fail(EILSEQ);
            uint32_t dist = kPosBase[pi];
            if (kPosXb[pi]) dist += static_cast<uint32_t>(br.read_bits(kPosXb[pi]));
            if (dist == 0 || dist > i + dlen || i + len > size) fail(ERANGE);
            for (uint32_t k = 0; k < len; k++, i++) o[i] = o[i - dist];
        }
    }
    if (dlen > 0) std::memcpy(out, o, i);
    if (state_out != nullptr) {
        lit.dump_state(state_out);
        pos.dump_state(state_out + lit.seed_words());
    }
    return i;
}

// ----------------------------------------------------- sqz4 range coder

// FORMAT.md §2.2: adaptive frequency model with Fenwick-tree cumulative
// queries (values identical to plain prefix sums; the tree is a speed
// optimization, as in the reference).
class ProbModel {
  public:
    explicit ProbModel(int n) {
        std::memset(freq_, 0, sizeof(freq_));
        for (int i = 0; i < n; i++) freq_[i] = 1;
        rebuild();
    }

    // sqzt v2 warm start (FORMAT.md §3.1): restore / snapshot raw freqs.
    void load_freqs(const uint32_t* f, int n) {
        std::memset(freq_, 0, sizeof(freq_));
        for (int i = 0; i < n; i++) freq_[i] = f[i];
        rebuild();
    }

    void dump_freqs(uint32_t* f, int n) const {
        for (int i = 0; i < n; i++) f[i] = static_cast<uint32_t>(freq_[i]);
    }

    uint64_t total() const { return total_; }
    uint64_t size(int sym) const { return freq_[sym]; }

    uint64_t start(int sym) const {  // cumulative frequency below sym
        uint64_t sum = 0;
        for (int i = sym - 1; i >= 0; i -= (i + 1) & -(i + 1)) sum += tree_[i];
        return sum;
    }

    void update(int sym) {
        if (total_ >= (1ull << 56)) return;  // freq cap (src/sqz.c:467)
        freq_[sym]++;
        total_++;
        for (int i = sym; i < 256; i += (i + 1) & -(i + 1)) tree_[i]++;
    }

    // symbol whose cumulative interval contains cum; -1 when out of range
    int index_of(uint64_t cum) const {
        if (cum >= total_) return -1;
        uint64_t value = cum;
        int i = 0;
        for (int mask = 128; mask != 0; mask >>= 1) {
            int t = i + mask;
            if (t <= 256 && value >= tree_[t - 1]) {
                i = t;
                value -= tree_[t - 1];
            }
        }
        // i = count of full prefix positions; the symbol is i (0-based) when
        // its frequency is nonzero
        return freq_[i] > 0 ? i : -1;
    }

  private:
    void rebuild() {
        std::memset(tree_, 0, sizeof(tree_));
        for (int i = 0; i < 256; i++) tree_[i] = freq_[i];
        for (int i = 1; i <= 256; i++) {
            int parent = i + (i & -i);
            if (parent <= 256) tree_[parent - 1] += tree_[i - 1];
        }
        total_ = 0;
        for (int i = 0; i < 256; i++) total_ += freq_[i];
    }

    uint64_t freq_[256];
    uint64_t tree_[256];
    uint64_t total_;
};

struct Sqz4Models {
    ProbModel literal{2}, size{256}, byte{256}, bits{32};
    std::vector<ProbModel> dist;
    Sqz4Models() : dist(32, ProbModel(2)) {}
};

// sqzt v2 model seed (FORMAT.md §3.1): flat u32[610] =
// literal[2] + size[256] + byte[256] + bits[32] + dist0[32] + dist1[32].
constexpr int kSeed4Words = 610;

void seed4_load(Sqz4Models& pm, const uint32_t* s) {
    pm.literal.load_freqs(s, 2);
    pm.size.load_freqs(s + 2, 256);
    pm.byte.load_freqs(s + 258, 256);
    pm.bits.load_freqs(s + 514, 32);
    for (int b = 0; b < 32; b++) {
        uint32_t f[2] = {s[546 + b], s[578 + b]};
        pm.dist[b].load_freqs(f, 2);
    }
}

// Normative capture rescale: per model, while total > 2^14, every nonzero
// freq becomes (freq+1)>>1 — bounds warm-block totals below 2^17, the
// device kernels' wide-divider exactness range.
void seed4_rescale(uint32_t* f, int n) {
    uint64_t tot = 0;
    for (int i = 0; i < n; i++) tot += f[i];
    while (tot > (1u << 14)) {
        tot = 0;
        for (int i = 0; i < n; i++) {
            if (f[i]) f[i] = (f[i] + 1) >> 1;
            tot += f[i];
        }
    }
}

void seed4_capture(const Sqz4Models& pm, uint32_t* s) {
    pm.literal.dump_freqs(s, 2);
    seed4_rescale(s, 2);
    pm.size.dump_freqs(s + 2, 256);
    seed4_rescale(s + 2, 256);
    pm.byte.dump_freqs(s + 258, 256);
    seed4_rescale(s + 258, 256);
    pm.bits.dump_freqs(s + 514, 32);
    seed4_rescale(s + 514, 32);
    for (int b = 0; b < 32; b++) {
        uint32_t f[2];
        pm.dist[b].dump_freqs(f, 2);
        seed4_rescale(f, 2);
        s[546 + b] = f[0];
        s[578 + b] = f[1];
    }
}

// Model seed derived from an op stream: fresh freqs (+1 everywhere) plus
// one update per coded op, then the normative capture rescale — identical
// to seed4_capture after actually coding the ops (updates are +1 per op).
void seed4_from_ops(const uint8_t* ms, const uint8_t* ss, uint64_t count,
                    uint32_t* s) {
    for (int k = 0; k < kSeed4Words; k++) s[k] = 0;
    s[0] = s[1] = 1;                              // literal
    for (int k = 0; k < 256; k++) s[2 + k] = 1;   // size
    for (int k = 0; k < 256; k++) s[258 + k] = 1; // byte
    for (int k = 0; k < 32; k++) s[514 + k] = 1;  // bits
    for (int k = 0; k < 64; k++) s[546 + k] = 1;  // dist
    for (uint64_t t = 0; t < count; t++) {
        int m = ms[t], sy = ss[t];
        if (m == 0) s[sy]++;
        else if (m == 1) s[2 + sy]++;
        else if (m == 2) s[258 + sy]++;
        else if (m == 3) s[514 + sy]++;
        else if (m >= 4 && m < 36) s[546 + 32 * sy + (m - 4)]++;
    }
    seed4_rescale(s, 2);
    seed4_rescale(s + 2, 256);
    seed4_rescale(s + 258, 256);
    seed4_rescale(s + 514, 32);
    for (int b = 0; b < 32; b++) {
        uint32_t f[2] = {s[546 + b], s[578 + b]};
        seed4_rescale(f, 2);
        s[546 + b] = f[0];
        s[578 + b] = f[1];
    }
}

class RangeEncoder {
  public:
    RangeEncoder(uint8_t* out, uint64_t cap) : out_(out), cap_(cap) {}

    void encode(ProbModel& pm, int sym) {
        uint64_t total = pm.total();
        uint64_t start = pm.start(sym);
        uint64_t size = pm.size(sym);
        range_ /= total;
        low_ += start * range_;
        range_ *= size;
        pm.update(sym);
        while ((low_ >> 56) == ((low_ + range_) >> 56)) emit();
        if (range_ < total + 1) {
            emit();
            emit();
            range_ = kMask64 - low_;
        }
    }

    void flush() {
        for (int i = 0; i < 8; i++) {
            range_ = kMask64;
            emit();
        }
    }

    uint64_t bytes() const { return len_; }

  private:
    void emit() {
        if (len_ >= cap_) fail(ENOBUFS);
        out_[len_++] = static_cast<uint8_t>(low_ >> 56);
        low_ <<= 8;
        range_ <<= 8;
    }

    uint8_t* out_;
    uint64_t cap_;
    uint64_t len_ = 0;
    uint64_t low_ = 0;
    uint64_t range_ = kMask64;
};

class RangeDecoder {
  public:
    RangeDecoder(const uint8_t* data, uint64_t n) : data_(data), n_(n) {
        for (int i = 0; i < 8; i++) code_ = (code_ << 8) + next_byte();
    }

    int decode(ProbModel& pm) {
        uint64_t total = pm.total();
        if (total < 1) fail(EINVAL);
        if (range_ < total) {
            consume();
            consume();
            range_ = kMask64 - low_;
        }
        // a crafted stream can leave range_ < total even after the reset
        // (low_ steered above kMask64 - total): range_/total == 0 there.
        // The reference divides first (UB/SIGFPE, src/sqz.c:536) and only
        // then maps range < total to EILSEQ (:541) — reject up front; no
        // encoder-produced stream reaches this state.
        uint64_t r = range_ / total;
        if (r == 0) fail(EILSEQ);
        uint64_t cum = (code_ - low_) / r;
        int sym = pm.index_of(cum);
        if (sym < 0) fail(EILSEQ);
        uint64_t start = pm.start(sym);
        uint64_t size = pm.size(sym);
        range_ /= total;
        low_ += start * range_;
        range_ *= size;
        pm.update(sym);
        while ((low_ >> 56) == ((low_ + range_) >> 56)) consume();
        return sym;
    }

  private:
    uint8_t next_byte() { return pos_ < n_ ? data_[pos_++] : 0; }

    void consume() {
        code_ = (code_ << 8) + next_byte();
        low_ <<= 8;
        range_ <<= 8;
    }

    const uint8_t* data_;
    uint64_t n_;
    uint64_t pos_ = 0;
    uint64_t low_ = 0;
    uint64_t range_ = kMask64;
    uint64_t code_ = 0;
};

constexpr int kSqz4MinLen = 2, kSqz4MaxLen = 254, kSqz4Eos = 0xFF;

uint64_t sqz4_encode_payload(const uint8_t* data, uint64_t n, uint32_t window,
                             int lz, uint8_t* out, uint64_t cap,
                             const uint32_t* seed = nullptr,
                             uint32_t* state_out = nullptr,
                             const uint8_t* dict = nullptr,
                             uint64_t dlen = 0,
                             int fast_depth = 0) {
    Sqz4Models pm;
    if (seed != nullptr) seed4_load(pm, seed);
    RangeEncoder enc(out, cap);
    if (lz) {
        // preset history (sqzt v2, FORMAT.md §3.1): match over dict + data,
        // tokenize from the first data byte; dist may reach into the dict.
        const uint8_t* base = data;
        uint64_t total = n, start = 0;
        std::vector<uint8_t> buf;
        if (dlen > 0) {
            buf.reserve(dlen + n);
            buf.insert(buf.end(), dict, dict + dlen);
            buf.insert(buf.end(), data, data + n);
            base = buf.data();
            total = dlen + n;
            start = dlen;
        }
        // fast_depth > 0: bounded approximate matcher (PERF.md round 3) —
        // streams stay spec-valid, only WHICH match is found changes
        auto run = [&](auto& mf) {
            for (uint64_t k = 0; k < start; k++) mf.insert(k);
            uint64_t i = start;
            while (i < total) {
                uint32_t len, dist;
                mf.find(i, &len, &dist);
                uint32_t nbits = 0;
                for (uint32_t d = dist; d != 0; d >>= 1) nbits++;
                // short-far rejection (src/sqz.c:678-685)
                if (len <= 3 && nbits > 3) len = 0;
                if (len >= kSqz4MinLen) {
                    enc.encode(pm.literal, 0);
                    enc.encode(pm.size, static_cast<int>(len));
                    enc.encode(pm.bits, static_cast<int>(nbits));
                    uint32_t d = dist;
                    for (uint32_t b = 0; b + 1 < nbits; b++) {
                        enc.encode(pm.dist[b], static_cast<int>(d & 1));
                        d >>= 1;
                    }
                    for (uint32_t k = 0; k < len; k++) mf.insert(i + k);
                    i += len;
                } else {
                    enc.encode(pm.literal, 1);
                    enc.encode(pm.byte, base[i]);
                    mf.insert(i);
                    i++;
                }
            }
        };
        if (fast_depth > 0) {
            FastMatchFinder mf(base, total, window, kSqz4MaxLen, fast_depth);
            run(mf);
        } else {
            MatchFinder mf(base, total, window, kSqz4MinLen, kSqz4MaxLen);
            run(mf);
        }
    } else {
        for (uint64_t i = 0; i < n; i++) {
            enc.encode(pm.literal, 1);
            enc.encode(pm.byte, data[i]);
        }
    }
    enc.encode(pm.literal, 0);
    enc.encode(pm.size, kSqz4Eos);
    enc.flush();
    if (state_out != nullptr) seed4_capture(pm, state_out);
    return enc.bytes();
}

uint64_t sqz4_decode_payload(const uint8_t* payload, uint64_t n,
                             uint8_t* out, uint64_t size,
                             const uint32_t* seed = nullptr,
                             uint32_t* state_out = nullptr,
                             const uint8_t* dict = nullptr,
                             uint64_t dlen = 0) {
    Sqz4Models pm;
    if (seed != nullptr) seed4_load(pm, seed);
    RangeDecoder dec(payload, n);
    // preset history (sqzt v2): decode into a dict-prefixed scratch so
    // matches can copy from the dictionary; result is copied back to out.
    std::vector<uint8_t> histbuf;
    uint8_t* o = out;
    if (dlen > 0) {
        histbuf.resize(dlen + size);
        std::memcpy(histbuf.data(), dict, dlen);
        o = histbuf.data() + dlen;
    }
    uint64_t i = 0;
    for (;;) {
        int flag = dec.decode(pm.literal);
        if (flag) {
            if (i >= size) fail(ENOBUFS);
            o[i++] = static_cast<uint8_t>(dec.decode(pm.byte));
        } else {
            int len = dec.decode(pm.size);
            if (len == kSqz4Eos) break;
            if (len < kSqz4MinLen || len > kSqz4MaxLen) fail(ERANGE);
            int nbits = dec.decode(pm.bits);
            uint32_t dist = 0;
            for (int b = 0; b + 1 < nbits; b++) {
                dist |= static_cast<uint32_t>(dec.decode(pm.dist[b])) << b;
            }
            // implicit MSB at nbits-1 (FORMAT.md §2.4; fixes src/sqz.c:821)
            if (nbits > 0) dist |= 1u << (nbits - 1);
            if (dist == 0 || dist > i + dlen) fail(ERANGE);
            if (i + static_cast<uint64_t>(len) > size) fail(ENOBUFS);
            for (int k = 0; k < len; k++, i++) o[i] = o[i - dist];
        }
    }
    if (dlen > 0) std::memcpy(out, o, i);
    if (state_out != nullptr) seed4_capture(pm, state_out);
    return i;
}

// Warm-start gate (sqzt v2 encoder policy, VERDICT r2 #5) — mirrors
// formats/constants.py warm_gate_mask EXACTLY (tests assert agreement):
// tail blocks are always seeded-pass candidates; full blocks only when at
// least kMinHits of the first kProbe positions have their little-endian
// 4-gram hash present in the dictionary's 2^kBits membership bitset.
struct WarmGate {
    static constexpr uint32_t kProbe = 2048;
    static constexpr uint32_t kMinHits = 32;
    static constexpr uint32_t kBits = 16;
    std::vector<uint8_t> set;
    uint64_t set_bits = 0;

    WarmGate(const uint8_t* dict, uint64_t dlen) : set(1u << kBits, 0) {
        for (uint64_t i = 0; i + 4 <= dlen; i++) {
            uint32_t g;
            std::memcpy(&g, dict + i, 4);
            set[(g * 2654435761u) >> (32 - kBits)] = 1;
        }
        for (uint8_t v : set) set_bits += v;
    }

    bool candidate(const uint8_t* p, uint64_t len, uint64_t full) const {
        if (len < full) return true;            // tail block
        const uint64_t probe = len < kProbe ? len : kProbe;
        if (probe < 4) return true;
        uint64_t hits = 0;
        for (uint64_t i = 0; i + 4 <= probe; i++) {
            uint32_t g;
            std::memcpy(&g, p + i, 4);
            hits += set[(g * 2654435761u) >> (32 - kBits)];
        }
        // threshold above the bitset's expected false-positive hits
        // (mirrors formats/constants.py exactly)
        const uint64_t expected = (set_bits * (probe - 3)) >> kBits;
        return hits >= expected + kMinHits;
    }
};

}  // namespace

// ----------------------------------------------------------------- C ABI

extern "C" {

// All entry points return the produced byte count, or -errno on failure.

int64_t sqz_squeeze_compress(const uint8_t* data, uint64_t n, int win_bits,
                             int with_header, uint8_t* out, uint64_t cap) {
    try {
        if (win_bits < 10 || win_bits > 15) return -EINVAL;
        BitWriter bw(out, cap);
        if (with_header) {
            bw.write_bits(n, 64);
            bw.write_bits(static_cast<uint64_t>(win_bits), 8);
        }
        squeeze_encode_payload(data, n, win_bits, bw);
        return static_cast<int64_t>(bw.bytes());
    } catch (const CodecError& e) {
        return -e.err;
    }
}

int64_t sqz_squeeze_decompress(const uint8_t* blob, uint64_t n,
                               int with_header, uint64_t size,
                               uint8_t* out, uint64_t cap) {
    try {
        BitReader br(blob, n);
        if (with_header) {
            size = br.read_bits(64);
            uint64_t win_bits = br.read_bits(8);
            if (win_bits < 10 || win_bits > 15) return -EILSEQ;
        }
        if (size > cap) return -ENOBUFS;
        return static_cast<int64_t>(squeeze_decode_payload(br, out, size));
    } catch (const CodecError& e) {
        return -e.err;
    }
}

int64_t sqz_sqz4_compress(const uint8_t* data, uint64_t n, uint32_t window,
                          int lz, uint8_t* out, uint64_t cap) {
    try {
        return static_cast<int64_t>(
            sqz4_encode_payload(data, n, window, lz, out, cap));
    } catch (const CodecError& e) {
        return -e.err;
    }
}

int64_t sqz_sqz4_decompress(const uint8_t* payload, uint64_t n, uint64_t size,
                            uint8_t* out, uint64_t cap) {
    try {
        if (size > cap) return -ENOBUFS;
        return static_cast<int64_t>(sqz4_decode_payload(payload, n, out, size));
    } catch (const CodecError& e) {
        return -e.err;
    }
}

// ---- seeded payload variants (sqzt v2 warm start, FORMAT.md §3.1).
// seed/state_out may be null; sqz4 seeds are u32[610], squeeze tree seeds
// are i64[6522] (lit flat state then pos flat state).

int64_t sqz_sqz4_compress_s(const uint8_t* data, uint64_t n, uint32_t window,
                            int lz, const uint32_t* seed, uint32_t* state_out,
                            const uint8_t* dict, uint64_t dlen,
                            uint8_t* out, uint64_t cap) {
    try {
        return static_cast<int64_t>(
            sqz4_encode_payload(data, n, window, lz, out, cap, seed,
                                state_out, dict, dlen));
    } catch (const CodecError& e) {
        return -e.err;
    }
}

// Fast-parse variant (bounded approximate matcher, PERF.md round 3):
// spec-valid streams, not byte-identical to the exact parse. For sqzt
// paths where the contract is round-trip + ratio (FORMAT.md §3) — the
// seeded/dictionary forms make the warm double-encode and the v3 anchor
// planner ~5x cheaper than the exact matcher.
int64_t sqz_sqz4_compress_f(const uint8_t* data, uint64_t n, uint32_t window,
                            int lz, int depth, const uint32_t* seed,
                            uint32_t* state_out,
                            const uint8_t* dict, uint64_t dlen,
                            uint8_t* out, uint64_t cap) {
    try {
        if (depth <= 0) return -EINVAL;
        return static_cast<int64_t>(
            sqz4_encode_payload(data, n, window, lz, out, cap, seed,
                                state_out, dict, dlen, depth));
    } catch (const CodecError& e) {
        return -e.err;
    }
}

int64_t sqz_sqz4_decompress_s(const uint8_t* payload, uint64_t n,
                              uint64_t size, const uint32_t* seed,
                              uint32_t* state_out,
                              const uint8_t* dict, uint64_t dlen,
                              uint8_t* out, uint64_t cap) {
    try {
        if (size > cap) return -ENOBUFS;
        return static_cast<int64_t>(
            sqz4_decode_payload(payload, n, out, size, seed, state_out,
                                dict, dlen));
    } catch (const CodecError& e) {
        return -e.err;
    }
}

int64_t sqz_squeeze_compress_s(const uint8_t* data, uint64_t n, int win_bits,
                               const int64_t* seed, int64_t* state_out,
                               const uint8_t* dict, uint64_t dlen,
                               uint8_t* out, uint64_t cap) {
    try {
        if (win_bits < 10 || win_bits > 15) return -EINVAL;
        BitWriter bw(out, cap);
        squeeze_encode_payload(data, n, win_bits, bw, seed, state_out,
                               dict, dlen);
        return static_cast<int64_t>(bw.bytes());
    } catch (const CodecError& e) {
        return -e.err;
    }
}

// Fast-parse squeeze encode (bounded approximate matcher): spec-valid
// streams for sqzt-contract paths; §1.5 exact policy remains the default
// (raw .sqz streams promise size parity with the reference).
int64_t sqz_squeeze_compress_f(const uint8_t* data, uint64_t n, int win_bits,
                               int depth, const int64_t* seed,
                               int64_t* state_out,
                               const uint8_t* dict, uint64_t dlen,
                               uint8_t* out, uint64_t cap) {
    try {
        if (win_bits < 10 || win_bits > 15 || depth <= 0) return -EINVAL;
        BitWriter bw(out, cap);
        squeeze_encode_payload(data, n, win_bits, bw, seed, state_out,
                               dict, dlen, depth);
        return static_cast<int64_t>(bw.bytes());
    } catch (const CodecError& e) {
        return -e.err;
    }
}

int64_t sqz_squeeze_decompress_s(const uint8_t* payload, uint64_t n,
                                 uint64_t size, const int64_t* seed,
                                 int64_t* state_out,
                                 const uint8_t* dict, uint64_t dlen,
                                 uint8_t* out, uint64_t cap) {
    try {
        if (size > cap) return -ENOBUFS;
        BitReader br(payload, n);
        return static_cast<int64_t>(
            squeeze_decode_payload(br, out, size, seed, state_out,
                                   dict, dlen));
    } catch (const CodecError& e) {
        return -e.err;
    }
}

// Encoder-side model-statistics precompute: given the sqz4 micro-op stream
// (model id, symbol) — model ids per FORMAT.md §2.2, -1 = pad, 36 = flush —
// simulate the 36 adaptive models and record each op's (start, size, total)
// BEFORE its update. The device encode scan then needs only the u64 coder
// registers (ops/sqz4_jax.encode_scan_stats_impl). Values fit u32 for any
// block < 4 GiB (totals grow by 1 per op).
int64_t sqz_sqz4_model_stats(const int32_t* m_ops, const int32_t* s_ops,
                             uint64_t t, const uint32_t* seed,
                             uint32_t* out_start,
                             uint32_t* out_size, uint32_t* out_total) {
    try {
        Sqz4Models pm;
        if (seed != nullptr) seed4_load(pm, seed);
        ProbModel* models[36] = {
            &pm.literal, &pm.size, &pm.byte, &pm.bits,
            &pm.dist[0], &pm.dist[1], &pm.dist[2], &pm.dist[3],
            &pm.dist[4], &pm.dist[5], &pm.dist[6], &pm.dist[7],
            &pm.dist[8], &pm.dist[9], &pm.dist[10], &pm.dist[11],
            &pm.dist[12], &pm.dist[13], &pm.dist[14], &pm.dist[15],
            &pm.dist[16], &pm.dist[17], &pm.dist[18], &pm.dist[19],
            &pm.dist[20], &pm.dist[21], &pm.dist[22], &pm.dist[23],
            &pm.dist[24], &pm.dist[25], &pm.dist[26], &pm.dist[27],
            &pm.dist[28], &pm.dist[29], &pm.dist[30], &pm.dist[31]};
        for (uint64_t i = 0; i < t; i++) {
            int32_t m = m_ops[i];
            if (m < 0 || m >= 36) {
                out_start[i] = 0;
                out_size[i] = 0;
                out_total[i] = 0;
                continue;
            }
            ProbModel& p = *models[m];
            int sym = s_ops[i];
            out_start[i] = static_cast<uint32_t>(p.start(sym));
            out_size[i] = static_cast<uint32_t>(p.size(sym));
            out_total[i] = static_cast<uint32_t>(p.total());
            p.update(sym);
        }
        return static_cast<int64_t>(t);
    } catch (const CodecError& e) {
        return -e.err;
    }
}

// Greedy tokenizer (FORMAT.md §1.5 / §2.4 match policy): fills out_tokens
// with (kind, a, b) triples — kind 0 = literal (a = byte), kind 1 = match
// (a = length, b = distance). reject_short_far applies the sqz4 rule
// (src/sqz.c:678-685). Returns the token count or -errno.
int64_t sqz_tokenize(const uint8_t* data, uint64_t n, uint32_t window,
                     int min_len, int max_len, int reject_short_far,
                     int32_t* out_tokens, uint64_t max_tokens) {
    try {
        MatchFinder mf(data, n, window, min_len, max_len);
        uint64_t i = 0, t = 0;
        while (i < n) {
            uint32_t len, dist;
            mf.find(i, &len, &dist);
            if (reject_short_far) {
                uint32_t nbits = 0;
                for (uint32_t d = dist; d != 0; d >>= 1) nbits++;
                if (len <= 3 && nbits > 3) len = 0;
            }
            if (t >= max_tokens) return -ENOBUFS;
            if (len >= static_cast<uint32_t>(min_len)) {
                out_tokens[3 * t] = 1;
                out_tokens[3 * t + 1] = static_cast<int32_t>(len);
                out_tokens[3 * t + 2] = static_cast<int32_t>(dist);
                for (uint32_t k = 0; k < len; k++) mf.insert(i + k);
                i += len;
            } else {
                out_tokens[3 * t] = 0;
                out_tokens[3 * t + 1] = data[i];
                out_tokens[3 * t + 2] = 0;
                mf.insert(i);
                i++;
            }
            t++;
        }
        return static_cast<int64_t>(t);
    } catch (const CodecError& e) {
        return -e.err;
    }
}

// Threaded block executor for the sqzt container (FORMAT.md §3): compresses
// ceil(n / 2^blk_bits) independent blocks in parallel. out_sizes must hold
// one entry per block; each block's payload is written at
// out + block_index * out_stride. Returns the block count or -errno.
int64_t sqz_blocks_compress(const uint8_t* data, uint64_t n, int fmt,
                            int win_bits, int blk_bits, int lz, int nthreads,
                            int warm, int fast_depth,
                            uint8_t* out, uint64_t out_stride,
                            int64_t* out_sizes, uint8_t* fresh_flags) {
    // fast_depth > 0 (sqz4 only): bounded approximate matcher for every
    // block — sqzt-contract paths (round-trip + ratio, FORMAT.md §3)
    auto enc4 = [&](const uint8_t* p, uint64_t len, const uint32_t* seed,
                    uint32_t* state_out, const uint8_t* d, uint64_t dl,
                    uint8_t* dst, uint64_t cap) -> int64_t {
        if (fast_depth > 0)
            return sqz_sqz4_compress_f(p, len, 1u << win_bits, lz,
                                       fast_depth, seed, state_out, d, dl,
                                       dst, cap);
        return sqz_sqz4_compress_s(p, len, 1u << win_bits, lz, seed,
                                   state_out, d, dl, dst, cap);
    };
    auto encS = [&](const uint8_t* p, uint64_t len, const int64_t* seed,
                    int64_t* state_out, const uint8_t* d, uint64_t dl,
                    uint8_t* dst, uint64_t cap) -> int64_t {
        if (fast_depth > 0)
            return sqz_squeeze_compress_f(p, len, win_bits, fast_depth,
                                          seed, state_out, d, dl, dst, cap);
        return sqz_squeeze_compress_s(p, len, win_bits, seed, state_out,
                                      d, dl, dst, cap);
    };
    const uint64_t bs = 1ull << blk_bits;
    const uint64_t nblocks = n == 0 ? 1 : (n + bs - 1) / bs;
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    // warm (sqzt v2): block 0 fresh first, capturing the seed + tail
    // dictionary; the pool then codes every other block BOTH fresh and
    // seeded and keeps the smaller, recording the choice in fresh_flags
    // (FORMAT.md §3.1 — warm never loses to cold per block).
    std::vector<uint32_t> seed4(kSeed4Words);
    std::vector<int64_t> seedt(kTreeSeedWords);
    const uint8_t* dict = nullptr;
    uint64_t dlen = 0;
    uint64_t first = 0;
    if (fresh_flags != nullptr) {
        for (uint64_t b = 0; b < nblocks; b++) fresh_flags[b] = 1;
    }
    if (warm && nblocks > 1) {
        uint64_t len0 = n < bs ? n : bs;
        if (fmt == 0) {
            out_sizes[0] = encS(data, len0, nullptr, seedt.data(),
                                nullptr, 0, out, out_stride);
            if (out_sizes[0] < 0) return out_sizes[0];
        } else {
            out_sizes[0] = enc4(data, len0, nullptr, seed4.data(),
                                nullptr, 0, out, out_stride);
            if (out_sizes[0] < 0) return out_sizes[0];
        }
        dlen = len0 < (1ull << win_bits) ? len0 : (1ull << win_bits);
        dict = data + (len0 - dlen);
        first = 1;
    } else {
        warm = 0;
    }
    // seeded passes only for gate candidates (VERDICT r2 #5): the pick
    // stays size-based per candidate block; non-candidates skip the
    // second encode entirely
    std::unique_ptr<WarmGate> wgate;
    if (warm) wgate.reset(new WarmGate(dict, dlen));
    std::vector<std::thread> pool;
    std::atomic<uint64_t> next{first};
    auto worker = [&]() {
        std::vector<uint8_t> alt(warm ? out_stride : 0);
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            const uint8_t* p = data + b * bs;
            uint64_t len = n - b * bs < bs ? n - b * bs : bs;
            uint8_t* dst = out + b * out_stride;
            const bool cand = warm && wgate->candidate(p, len, bs);
            if (fmt == 0) {
                out_sizes[b] = encS(p, len, nullptr, nullptr,
                                    nullptr, 0, dst, out_stride);
                if (cand && out_sizes[b] >= 0) {
                    int64_t ws = encS(p, len, seedt.data(), nullptr,
                                      dict, dlen, alt.data(), out_stride);
                    if (ws >= 0 && ws < out_sizes[b]) {
                        std::memcpy(dst, alt.data(),
                                    static_cast<size_t>(ws));
                        out_sizes[b] = ws;
                        if (fresh_flags != nullptr) fresh_flags[b] = 0;
                    }
                }
            } else {
                out_sizes[b] = enc4(p, len, nullptr, nullptr,
                                    nullptr, 0, dst, out_stride);
                if (cand && out_sizes[b] >= 0) {
                    int64_t ws = enc4(p, len, seed4.data(), nullptr,
                                      dict, dlen, alt.data(), out_stride);
                    if (ws >= 0 && ws < out_sizes[b]) {
                        std::memcpy(dst, alt.data(),
                                    static_cast<size_t>(ws));
                        out_sizes[b] = ws;
                        if (fresh_flags != nullptr) fresh_flags[b] = 0;
                    }
                }
            }
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    for (uint64_t b = 0; b < nblocks; b++) {
        if (out_sizes[b] < 0) return out_sizes[b];
    }
    return static_cast<int64_t>(nblocks);
}

// Mirror: parallel decode of independent blocks into a contiguous buffer.
int64_t sqz_blocks_decompress(const uint8_t* payloads, const int64_t* offsets,
                              const int64_t* sizes, uint64_t nblocks, int fmt,
                              int blk_bits, int win_bits, int nthreads,
                              int warm, const uint8_t* fresh_flags,
                              uint8_t* out, uint64_t total_size) {
    const uint64_t bs = 1ull << blk_bits;
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> pool;
    std::vector<int64_t> results(nblocks, 0);
    // warm (sqzt v2): block 0 decodes fresh first, re-deriving the seed and
    // the shared dictionary the encoder used for blocks 1+ (FORMAT.md §3.1 —
    // nothing is stored in the container).
    std::vector<uint32_t> seed4(kSeed4Words);
    std::vector<int64_t> seedt(kTreeSeedWords);
    const uint8_t* dict = nullptr;
    uint64_t dlen = 0;
    uint64_t first = 0;
    if (warm && nblocks > 1) {
        uint64_t len0 = total_size < bs ? total_size : bs;
        if (fmt == 0) {
            results[0] = sqz_squeeze_decompress_s(
                payloads + offsets[0], static_cast<uint64_t>(sizes[0]),
                len0, nullptr, seedt.data(), nullptr, 0, out, len0);
        } else {
            results[0] = sqz_sqz4_decompress_s(
                payloads + offsets[0], static_cast<uint64_t>(sizes[0]),
                len0, nullptr, seed4.data(), nullptr, 0, out, len0);
        }
        if (results[0] < 0) return results[0];
        // the shared dictionary derives from block 0's bytes: a short
        // decode (early EOS in a corrupt payload) would seed every warm
        // block from uninitialized memory
        if (static_cast<uint64_t>(results[0]) != len0) return -EILSEQ;
        dlen = len0 < (1ull << win_bits) ? len0 : (1ull << win_bits);
        dict = out + (len0 - dlen);
        first = 1;
    } else {
        warm = 0;
    }
    std::atomic<uint64_t> next{first};
    auto worker = [&]() {
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            uint64_t off = b * bs;
            uint64_t len = total_size - off < bs ? total_size - off : bs;
            // per-block choice (FORMAT.md §3.1 fresh bitmap)
            bool seeded = warm && !(fresh_flags != nullptr && fresh_flags[b]);
            if (fmt == 0) {
                results[b] = sqz_squeeze_decompress_s(
                    payloads + offsets[b], static_cast<uint64_t>(sizes[b]),
                    len, seeded ? seedt.data() : nullptr, nullptr,
                    seeded ? dict : nullptr, seeded ? dlen : 0,
                    out + off, len);
            } else {
                results[b] = sqz_sqz4_decompress_s(
                    payloads + offsets[b], static_cast<uint64_t>(sizes[b]),
                    len, seeded ? seed4.data() : nullptr, nullptr,
                    seeded ? dict : nullptr, seeded ? dlen : 0,
                    out + off, len);
            }
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    for (uint64_t b = 0; b < nblocks; b++) {
        if (results[b] < 0) return results[b];
        uint64_t off = b * bs;
        uint64_t len = total_size - off < bs ? total_size - off : bs;
        // a short sqz4 decode (early EOS in a corrupt payload) must not
        // be accepted as success — the tail would be uninitialized bytes
        if (static_cast<uint64_t>(results[b]) != len) return -EILSEQ;
    }
    return static_cast<int64_t>(total_size);
}

// Reconstruct output bytes from the TPU decode kernel's record streams
// (sqz_tpu/ops/sqz4_pallas.py): per block, a token-kind bitstream
// (LSB-first within u32 words), a dense literal-byte stream (big-endian
// within u32 words, already byte-ordered here as u8), and match records
// (len << 16 | dist). Batched + threaded over blocks.
int64_t sqz_assemble_blocks(const uint32_t* tok, uint64_t tok_stride,
                            const uint8_t* lit, uint64_t lit_stride,
                            const uint32_t* mrec, uint64_t mrec_stride,
                            const int64_t* ntok, const int64_t* sizes,
                            uint64_t nblocks, int nthreads,
                            const uint8_t* dict, uint64_t dlen,
                            uint8_t* out, uint64_t out_stride) {
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> pool;
    std::atomic<uint64_t> next{0};
    std::atomic<int64_t> fail{0};
    auto worker = [&]() {
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            const uint32_t* tk = tok + b * tok_stride;
            const uint8_t* li = lit + b * lit_stride;
            const uint32_t* mr = mrec + b * mrec_stride;
            uint8_t* dst = out + b * out_stride;
            uint64_t pos = 0, mi = 0, ln = 0;
            const uint64_t limit =
                out_stride < static_cast<uint64_t>(sizes[b])
                    ? out_stride : static_cast<uint64_t>(sizes[b]);
            // inconsistent record streams (only possible via misuse or a
            // kernel bug — corrupt payloads error before assembly) must
            // fail EILSEQ, not read past the per-block rows
            if (static_cast<uint64_t>(ntok[b]) > tok_stride * 32) {
                fail.store(-EILSEQ);
                return;
            }
            for (int64_t t = 0; t < ntok[b]; t++) {
                if ((tk[t >> 5] >> (t & 31)) & 1u) {
                    if (mi >= mrec_stride) { fail.store(-EILSEQ); return; }
                    uint32_t rec = mr[mi++];
                    uint32_t len = rec >> 16, dist = rec & 0xFFFF;
                    if (dist == 0 || dist > pos + dlen || pos + len > limit) {
                        fail.store(-EILSEQ);
                        return;
                    }
                    for (uint32_t k = 0; k < len; k++, pos++) {
                        // dist may reach into the shared warm dictionary
                        // (FORMAT.md §3.1) for the first bytes of a block
                        dst[pos] = pos >= dist
                                       ? dst[pos - dist]
                                       : dict[dlen - dist + pos];
                    }
                } else {
                    if (pos >= limit) { fail.store(-ENOBUFS); return; }
                    if (ln >= lit_stride) { fail.store(-EILSEQ); return; }
                    dst[pos++] = li[ln++];
                }
            }
            if (pos != static_cast<uint64_t>(sizes[b])) fail.store(-EILSEQ);
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    if (fail.load() != 0) return fail.load();
    return static_cast<int64_t>(nblocks);
}

// Plan + pack the sqz4 encoder's device input in one threaded pass:
// tokenize each 2^blk_bits block (greedy, reject-short-far — the sqz4
// policy), expand to (model, symbol) micro-ops, and write them straight
// into the TPU kernel's [G, Tp/4, lanes] u32 layout (4 big-endian u8 ops
// per word; model 255 = pad, 254 = flush). m_words/s_words must be sized
// for tp_rows = tp_cap/4 rows per group and PRE-FILLED by the caller
// (m: 0xFFFFFFFF pad pattern, s: 0). Returns max ops per block or -errno.
int64_t sqz4_plan_pack(const uint8_t* data, uint64_t n, uint32_t window,
                       int blk_bits, int lz, uint64_t lanes, uint64_t tp_cap,
                       int nthreads, int warm, int paired,
                       uint32_t* seed_out,
                       uint32_t* m_words, uint32_t* s_words,
                       int64_t* op_counts) {
    const uint64_t bs = 1ull << blk_bits;
    const uint64_t nblocks = n == 0 ? 1 : (n + bs - 1) / bs;
    const uint64_t tp_rows = tp_cap / 4;
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    // warm (sqzt v2): blocks 1+ tokenize against block 0's tail dictionary.
    // The op stream does not depend on the model seed, so planning stays
    // fully parallel; the seed for the device tables is derived afterwards
    // from block 0's op histogram (seed_out, kSeed4Words).
    const uint8_t* dict = nullptr;
    uint64_t dlen = 0;
    if (warm && nblocks > 1 && lz) {
        uint64_t len0 = n < bs ? n : bs;
        dlen = len0 < window ? len0 : window;
        dict = data + (len0 - dlen);
    }
    std::vector<std::thread> pool;
    std::atomic<uint64_t> next{0};
    std::atomic<int64_t> fail{0};
    auto worker = [&]() {
        std::vector<uint8_t> ms, ss, buf;
        ms.reserve(2 * bs + 16);
        ss.reserve(2 * bs + 16);
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            const uint8_t* blk = data + b * bs;
            const uint64_t len = (n - b * bs) < bs ? (n - b * bs) : bs;
            ms.clear();
            ss.clear();
            try {
                if (lz) {
                    const uint8_t* base = blk;
                    uint64_t total = len, start = 0;
                    if (b > 0 && dlen > 0) {
                        buf.clear();
                        buf.insert(buf.end(), dict, dict + dlen);
                        buf.insert(buf.end(), blk, blk + len);
                        base = buf.data();
                        total = dlen + len;
                        start = dlen;
                    }
                    MatchFinder mf(base, total, window, 2, 254);
                    for (uint64_t k = 0; k < start; k++) mf.insert(k);
                    uint64_t i = start;
                    while (i < total) {
                        uint32_t mlen, dist;
                        mf.find(i, &mlen, &dist);
                        uint32_t nbits = 0;
                        for (uint32_t d = dist; d != 0; d >>= 1) nbits++;
                        if (mlen <= 3 && nbits > 3) mlen = 0;
                        if (mlen >= 2) {
                            ms.push_back(0); ss.push_back(0);
                            ms.push_back(1); ss.push_back(
                                static_cast<uint8_t>(mlen));
                            ms.push_back(3); ss.push_back(
                                static_cast<uint8_t>(nbits));
                            uint32_t d = dist;
                            for (uint32_t k = 0; k + 1 < nbits; k++) {
                                ms.push_back(static_cast<uint8_t>(4 + k));
                                ss.push_back(d & 1);
                                d >>= 1;
                            }
                            // paired grammar (fused kernel): a match spans
                            // nbits+2 ops — one pad realigns odd spans so
                            // slot 2 of every pair is the only slot that
                            // can hold a byte/size (256-table) op
                            if (paired && (nbits & 1)) {
                                ms.push_back(255); ss.push_back(0);
                            }
                            for (uint32_t k = 0; k < mlen; k++) mf.insert(i + k);
                            i += mlen;
                        } else {
                            ms.push_back(0); ss.push_back(1);
                            ms.push_back(2); ss.push_back(base[i]);
                            mf.insert(i);
                            i++;
                        }
                    }
                } else {
                    for (uint64_t i = 0; i < len; i++) {
                        ms.push_back(0); ss.push_back(1);
                        ms.push_back(2); ss.push_back(data[b * bs + i]);
                    }
                }
            } catch (const CodecError& e) {
                fail.store(-e.err);
                return;
            }
            // EOS + 8 flush emissions
            ms.push_back(0); ss.push_back(0);
            ms.push_back(1); ss.push_back(0xFF);
            for (int k = 0; k < 8; k++) { ms.push_back(254); ss.push_back(0); }
            // packed writes land in tp_cap/4 rows: bound by the row
            // capacity, not tp_cap itself (callers pass multiples of 4,
            // but the C ABI must not rely on it)
            if (ms.size() > (tp_cap / 4) * 4) { fail.store(-ENOBUFS); return; }
            op_counts[b] = static_cast<int64_t>(ms.size());
            if (warm && b == 0 && seed_out != nullptr) {
                seed4_from_ops(ms.data(), ss.data(), ms.size(), seed_out);
            }
            const uint64_t g = b / lanes, lane = b % lanes;
            uint32_t* mw = m_words + g * tp_rows * lanes;
            uint32_t* sw = s_words + g * tp_rows * lanes;
            for (uint64_t t = 0; t < ms.size(); t++) {
                const uint64_t cell = (t >> 2) * lanes + lane;
                const uint32_t sh = 24 - 8 * (t & 3);
                mw[cell] = (mw[cell] & ~(0xFFu << sh))
                           | (static_cast<uint32_t>(ms[t]) << sh);
                sw[cell] = (sw[cell] & ~(0xFFu << sh))
                           | (static_cast<uint32_t>(ss[t]) << sh);
            }
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    if (fail.load() != 0) return fail.load();
    int64_t mx = 0;
    for (uint64_t b = 0; b < nblocks; b++) mx = std::max(mx, op_counts[b]);
    return mx;
}

// Fast planning pass for the sqzt TPU encode pipeline (VERDICT r2 #1):
// tokenize each block with the bounded FastMatchFinder and emit the
// (model, symbol) micro-op stream CONTIGUOUSLY per block — m8/s8 are
// [nblocks, tp_cap] row-major u8 (caller-prefilled: m8 = 255 pad, s8 = 0).
// The device-layout transpose/word-pack that made the exact path
// cache-hostile (every op a ~2 KiB-strided RMW) moves to the TPU, where a
// [G, lanes, rows*4] u8 -> [G, rows, lanes] u32 relayout is a trivial
// fused XLA reshape. Grammar identical to sqz4_plan_pack, including the
// paired-slot pad after odd-span matches. Returns max ops/block or -errno.
int64_t sqz4_fast_plan(const uint8_t* data, uint64_t n, uint32_t window,
                       int blk_bits, int lz, uint64_t tp_cap, int nthreads,
                       int warm, int paired, int depth,
                       uint32_t* seed_out,
                       uint8_t* m8, uint8_t* s8, int64_t* op_counts) {
    const uint64_t bs = 1ull << blk_bits;
    const uint64_t nblocks = n == 0 ? 1 : (n + bs - 1) / bs;
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    const uint8_t* dict = nullptr;
    uint64_t dlen = 0;
    if (warm && nblocks > 1 && lz) {
        uint64_t len0 = n < bs ? n : bs;
        dlen = len0 < window ? len0 : window;
        dict = data + (len0 - dlen);
    }
    std::vector<std::thread> pool;
    std::atomic<uint64_t> next{0};
    std::atomic<int64_t> fail{0};
    auto worker = [&]() {
        FastMatchFinder mf(data, 0, window, 254, depth);
        std::vector<uint8_t> buf;
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            const uint8_t* blk = data + b * bs;
            const uint64_t len = (n - b * bs) < bs ? (n - b * bs) : bs;
            uint8_t* mrow = m8 + b * tp_cap;
            uint8_t* srow = s8 + b * tp_cap;
            uint64_t t = 0;
            // worst-case ops left for one token: flag+size+bits+13 dist
            // bits + paired pad = 17; EOS tail needs 2 + 8 more
            const uint64_t kTail = 32;
            // the EOS+flush tail writes unconditionally below — guard it
            // here too (the in-loop guard never runs for an empty block)
            if (kTail > tp_cap) { fail.store(-ENOBUFS); return; }
            if (lz) {
                const uint8_t* base = blk;
                uint64_t total = len, start = 0;
                if (b > 0 && dlen > 0) {
                    buf.clear();
                    buf.insert(buf.end(), dict, dict + dlen);
                    buf.insert(buf.end(), blk, blk + len);
                    base = buf.data();
                    total = dlen + len;
                    start = dlen;
                }
                mf.reset(base, total);
                for (uint64_t k = 0; k < start; k++) mf.insert(k);
                uint64_t i = start;
                while (i < total) {
                    if (t + kTail > tp_cap) { fail.store(-ENOBUFS); return; }
                    uint32_t mlen, dist;
                    mf.find(i, &mlen, &dist);
                    uint32_t nbits = 0;
                    for (uint32_t d = dist; d != 0; d >>= 1) nbits++;
                    if (mlen <= 3 && nbits > 3) mlen = 0;  // reject rule
                    if (mlen >= 2) {
                        mrow[t] = 0; srow[t] = 0; t++;
                        mrow[t] = 1; srow[t] = static_cast<uint8_t>(mlen); t++;
                        mrow[t] = 3; srow[t] = static_cast<uint8_t>(nbits); t++;
                        uint32_t d = dist;
                        for (uint32_t k = 0; k + 1 < nbits; k++) {
                            mrow[t] = static_cast<uint8_t>(4 + k);
                            srow[t] = d & 1;
                            t++;
                            d >>= 1;
                        }
                        if (paired && (nbits & 1)) { mrow[t] = 255; srow[t] = 0; t++; }
                        for (uint32_t k = 0; k < mlen; k++) mf.insert(i + k);
                        i += mlen;
                    } else {
                        mrow[t] = 0; srow[t] = 1; t++;
                        mrow[t] = 2; srow[t] = base[i]; t++;
                        mf.insert(i);
                        i++;
                    }
                }
            } else {
                if (2 * len + kTail > tp_cap) { fail.store(-ENOBUFS); return; }
                for (uint64_t i = 0; i < len; i++) {
                    mrow[t] = 0; srow[t] = 1; t++;
                    mrow[t] = 2; srow[t] = blk[i]; t++;
                }
            }
            // EOS + 8 flush emissions
            mrow[t] = 0; srow[t] = 0; t++;
            mrow[t] = 1; srow[t] = 0xFF; t++;
            for (int k = 0; k < 8; k++) { mrow[t] = 254; srow[t] = 0; t++; }
            op_counts[b] = static_cast<int64_t>(t);
            if (warm && b == 0 && seed_out != nullptr) {
                seed4_from_ops(mrow, srow, t, seed_out);
            }
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    if (fail.load() != 0) return fail.load();
    int64_t mx = 0;
    for (uint64_t b = 0; b < nblocks; b++) mx = std::max(mx, op_counts[b]);
    return mx;
}

// Token-level planning for the token-input encoder kernel (PERF.md round
// 3): instead of the expanded (model, symbol) micro-op stream (~4.5 B per
// input byte on the wire), emit one u32 TOKEN per parse decision plus a
// dense literal-byte stream (~1.1 B/B total) — the kernel expands tokens
// to fused coder pairs on the fly. Token word layout:
//   bits 0..7   literal-run count (1..255) | match len (2..254) | 255 EOS
//   bit  8      1 = match / EOS, 0 = literal run
//   bits 9..13  match distance bit-length (1..15)
//   bits 16..30 match distance (< 2^15)
//   0           pad (terminates a lane defensively)
// tok/lit arrays are [nblocks, tok_cap] u32 / [nblocks, lit_cap] u8,
// caller-zeroed. counts rows per block: [n_tok, n_lit, n_pairs]; n_pairs
// matches the fused op-stream pairing exactly (ceil((nbits+2)/2) per
// match, 1 per literal byte, 5 for EOS+flush). A block whose parse
// exceeds tok_cap/lit_cap gets n_pairs = -1 (the caller routes it to the
// op-stream kernel); the return is max pairs over the fitting blocks.
int64_t sqz4_tok_plan(const uint8_t* data, uint64_t n, uint32_t window,
                      int blk_bits, int lz, uint64_t tok_cap,
                      uint64_t lit_cap, int nthreads, int depth,
                      uint32_t* toks, uint8_t* lits, int64_t* counts) {
    const uint64_t bs = 1ull << blk_bits;
    const uint64_t nblocks = n == 0 ? 1 : (n + bs - 1) / bs;
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> pool;
    std::atomic<uint64_t> next{0};
    std::atomic<int64_t> fail{0};
    auto worker = [&]() {
        FastMatchFinder mf(data, 0, window, 254, depth);
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            const uint8_t* blk = data + b * bs;
            const uint64_t len = (n - b * bs) < bs ? (n - b * bs) : bs;
            uint32_t* trow = toks + b * tok_cap;
            uint8_t* lrow = lits + b * lit_cap;
            uint64_t nt = 0, nl = 0, pairs = 0;
            uint32_t run = 0;
            bool over = false;
            auto flush_run = [&]() {
                if (run) {
                    if (nt >= tok_cap) { over = true; return false; }
                    trow[nt++] = run;       // literal-run token
                    run = 0;
                }
                return true;
            };
            if (lz) {
                mf.reset(blk, len);
                uint64_t i = 0;
                while (i < len && !over) {
                    uint32_t mlen, dist;
                    mf.find(i, &mlen, &dist);
                    uint32_t nbits = 0;
                    for (uint32_t d = dist; d != 0; d >>= 1) nbits++;
                    if (mlen <= 3 && nbits > 3) mlen = 0;   // reject rule
                    if (mlen >= 2) {
                        if (!flush_run()) break;
                        if (nt >= tok_cap) { over = true; break; }
                        trow[nt++] = mlen | (1u << 8) | (nbits << 9)
                                     | (dist << 16);
                        pairs += 2 + (nbits > 2 ? (nbits - 1) / 2 : 0);
                        for (uint32_t k = 0; k < mlen; k++) mf.insert(i + k);
                        i += mlen;
                    } else {
                        if (nl >= lit_cap) { over = true; break; }
                        lrow[nl++] = blk[i];
                        pairs++;
                        if (++run == 255 && !flush_run()) break;
                        mf.insert(i);
                        i++;
                    }
                }
                if (!over) flush_run();
            } else {
                if (len > lit_cap || (len + 254) / 255 + 1 > tok_cap) {
                    over = true;
                } else {
                    std::memcpy(lrow, blk, len);
                    nl = len;
                    pairs = len;
                    for (uint64_t r = len; r > 0;) {
                        uint32_t c = r < 255 ? static_cast<uint32_t>(r) : 255;
                        trow[nt++] = c;
                        r -= c;
                    }
                }
            }
            if (!over && nt >= tok_cap) over = true;
            if (over) {
                counts[b * 3 + 0] = 0;
                counts[b * 3 + 1] = 0;
                counts[b * 3 + 2] = -1;  // caller: op-stream path
                continue;
            }
            trow[nt++] = 0xFFu | (1u << 8);     // EOS
            pairs += 5;                          // (flag,size) + 4 flush
            counts[b * 3 + 0] = static_cast<int64_t>(nt);
            counts[b * 3 + 1] = static_cast<int64_t>(nl);
            counts[b * 3 + 2] = static_cast<int64_t>(pairs);
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    if (fail.load() != 0) return fail.load();
    int64_t mx = 0;
    for (uint64_t b = 0; b < nblocks; b++) mx = std::max(mx, counts[b * 3 + 2]);
    return mx;
}

// Pack block payloads into the decode kernel's [G, Pw, lanes] u32 word
// layout (big-endian bytes within words). payloads are concatenated with
// offsets/sizes; arrays must be caller-zeroed.
int64_t sqz4_pack_payloads(const uint8_t* payloads, const int64_t* offsets,
                           const int64_t* sizes, uint64_t nblocks,
                           uint64_t lanes, uint64_t pw, int nthreads,
                           uint32_t* words) {
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> pool;
    std::atomic<uint64_t> next{0};
    std::atomic<int64_t> fail{0};
    auto worker = [&]() {
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            const uint8_t* p = payloads + offsets[b];
            const uint64_t len = static_cast<uint64_t>(sizes[b]);
            if (len > pw * 4) { fail.store(-ENOBUFS); return; }
            const uint64_t g = b / lanes, lane = b % lanes;
            uint32_t* w = words + g * pw * lanes + lane;
            for (uint64_t j = 0; j < len; j++) {
                w[(j >> 2) * lanes] |= static_cast<uint32_t>(p[j])
                                       << (24 - 8 * (j & 3));
            }
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    if (fail.load() != 0) return fail.load();
    return static_cast<int64_t>(nblocks);
}

// FNV-1a 64-bit over a byte buffer — the integrity hook the reference
// computes on every io_put/io_get byte but never verifies
// (reference inc/rt/fileio.h:120-129); the sqzt container stores and
// verifies it.
uint64_t sqz_fnv1a64(const uint8_t* data, uint64_t n) {
    uint64_t h = 0xCBF29CE484222325ull;
    for (uint64_t i = 0; i < n; i++) {
        h ^= data[i];
        h *= 0x100000001B3ull;
    }
    return h;
}

// Plan + pack the squeeze encoder's device input: run the full adaptive
// Huffman encode per block (trees + match finder at host speed) but record
// the bitstream WRITES instead of packing them; the TPU packer kernel
// assembles the payload bits. One u32 per write in the kernel's
// [G, Tw, lanes] layout (0 = pad). Returns max writes per block or -errno.
int64_t squeeze_plan_pack(const uint8_t* data, uint64_t n, int win_bits,
                          int blk_bits, uint64_t lanes, uint64_t tw_cap,
                          int nthreads, int warm, int fast_depth,
                          uint32_t* words) {
    // workers call squeeze_encode_payload directly (no win_bits gate
    // downstream); pos_index is 2^15 entries — validate up front
    if (win_bits < 10 || win_bits > 15) return -EINVAL;
    const uint64_t bs = 1ull << blk_bits;
    const uint64_t nblocks = n == 0 ? 1 : (n + bs - 1) / bs;
    if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> pool;
    std::atomic<int64_t> fail_{0};
    std::vector<int64_t> counts(nblocks, 0);
    // warm (sqzt v2, FORMAT.md §3.1): block 0 plans first, capturing the
    // tree seed + tail dictionary every other block starts from.
    std::vector<int64_t> seedt(kTreeSeedWords);
    const uint8_t* dict = nullptr;
    uint64_t dlen = 0;
    uint64_t first = 0;
    if (warm && nblocks > 1) {
        uint64_t len0 = n < bs ? n : bs;
        std::vector<uint32_t> ws;
        try {
            WriteRecorder rec(ws);
            squeeze_encode_payload(data, len0, win_bits, rec, nullptr,
                                   seedt.data(), nullptr, 0, fast_depth);
        } catch (const CodecError& e) {
            return -e.err;
        }
        if (ws.size() > tw_cap) return -ENOBUFS;
        counts[0] = static_cast<int64_t>(ws.size());
        for (uint64_t t = 0; t < ws.size(); t++) words[t * lanes] = ws[t];
        dlen = len0 < (1ull << win_bits) ? len0 : (1ull << win_bits);
        dict = data + (len0 - dlen);
        first = 1;
    } else {
        warm = 0;
    }
    std::atomic<uint64_t> next{first};
    auto worker = [&]() {
        std::vector<uint32_t> ws;
        for (;;) {
            uint64_t b = next.fetch_add(1);
            if (b >= nblocks) return;
            const uint8_t* blk = data + b * bs;
            const uint64_t len = (n - b * bs) < bs ? (n - b * bs) : bs;
            ws.clear();
            try {
                WriteRecorder rec(ws);
                squeeze_encode_payload(blk, len, win_bits, rec,
                                       warm ? seedt.data() : nullptr,
                                       nullptr, dict, dlen, fast_depth);
            } catch (const CodecError& e) {
                fail_.store(-e.err);
                return;
            }
            if (ws.size() > tw_cap) { fail_.store(-ENOBUFS); return; }
            counts[b] = static_cast<int64_t>(ws.size());
            const uint64_t g = b / lanes, lane = b % lanes;
            uint32_t* w = words + g * tw_cap * lanes + lane;
            for (uint64_t t = 0; t < ws.size(); t++) w[t * lanes] = ws[t];
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    if (fail_.load() != 0) return fail_.load();
    int64_t mx = 0;
    for (uint64_t b = 0; b < nblocks; b++) mx = std::max(mx, counts[b]);
    return mx;
}

}  // extern "C"

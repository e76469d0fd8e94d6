// METEOR 1.5 scorer core — C++ replacement for the reference's
// meteor-1.5.jar subprocess (ClipCap's clipcap/eval/pycocoevalcap/
// meteor/meteor.py:21-63). Behavior is the spec defined by
// clipcap_tpu_torch/eval/meteor.py (exact / Snowball-stem / paraphrase matcher
// stages, beam-search alignment, METEOR 1.5 English parameters); the two
// implementations are cross-tested for identical scores.
#include <algorithm>
#include <bitset>
#include <cctype>
#include <cmath>
#include <cstring>
#include <fstream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

#include "porter.h"
#include "snowball.h"

namespace {

// METEOR 1.5 English defaults (WMT rank-tuned; `-l en`, no -t flag).
constexpr double ALPHA = 0.85;
constexpr double BETA = 0.2;
constexpr double GAMMA = 0.6;
constexpr double DELTA = 0.75;
const double STAGE_WEIGHTS[4] = {1.0, 0.6, 0.8, 0.6};  // exact stem syn par
constexpr int BEAM_WIDTH = 40;
constexpr size_t MAX_TOKENS = 256;  // beam masks are fixed-width bitsets

const std::set<std::string>& function_words() {
    // Keep in sync with clipcap_tpu_torch/eval/meteor.py FUNCTION_WORDS.
    static const std::set<std::string> s = [] {
        const char* words =
            "a an the this that these those some any each every no "
            "i you he she it we they me him her us them my your his its our their "
            "mine yours hers ours theirs myself yourself himself herself itself ourselves themselves "
            "am is are was were be been being do does did doing have has had having "
            "will would shall should may might must can could ought "
            "and or but nor so yet for if while although though because since unless until when whenever "
            "where wherever whether as than that which who whom whose what "
            "in on at by with from into onto of to up down over under above below between among "
            "through during before after about against along around behind beside besides beyond "
            "despite except inside outside toward towards upon within without "
            "not n't there here then now just only also very too quite rather";
        std::set<std::string> out;
        std::istringstream iss(words);
        std::string w;
        while (iss >> w) out.insert(w);
        return out;
    }();
    return s;
}

// `-norm`-style preprocessing: ASCII lowercase + split ASCII punctuation
// (except apostrophe) into separate tokens; non-ASCII bytes pass through
// as word characters (mirrors eval/meteor.py normalize()).
std::vector<std::string> normalize(const std::string& text) {
    std::string spaced;
    spaced.reserve(text.size() * 2);
    for (char c : text) {
        unsigned char u = static_cast<unsigned char>(c);
        char lc = u < 0x80 ? static_cast<char>(std::tolower(u)) : c;
        bool is_word = (u >= 0x80) || std::isalnum(u) || lc == '\'' || lc == ' ';
        if (!is_word) {
            spaced.push_back(' ');
            spaced.push_back(lc);
            spaced.push_back(' ');
        } else {
            spaced.push_back(lc);
        }
    }
    std::vector<std::string> out;
    std::istringstream iss(spaced);
    std::string w;
    while (iss >> w && out.size() < MAX_TOKENS) out.push_back(w);
    return out;
}

struct Match {
    int h, hl, r, rl, stage;
};

using Mask = std::bitset<MAX_TOKENS>;

Mask span_mask(int start, int len) {
    Mask m;
    for (int k = 0; k < len; ++k) m.set(start + k);
    return m;
}

struct ParaphraseTable {
    std::map<std::string, std::set<std::string>> table;
    int max_phrase = 1;

    // Plain-text table: "phrase ||| paraphrase" (or tab-separated) lines.
    bool load(const std::string& path) {
        std::ifstream f(path);
        if (!f) return false;
        std::string line;
        while (std::getline(f, line)) {
            size_t sep = line.find("|||");
            std::string a, b;
            if (sep != std::string::npos) {
                a = line.substr(0, sep);
                b = line.substr(sep + 3);
            } else {
                size_t tab = line.find('\t');
                if (tab == std::string::npos) continue;
                a = line.substr(0, tab);
                b = line.substr(tab + 1);
            }
            auto trim = [](std::string s) {
                size_t b0 = s.find_first_not_of(" \t\r\n");
                size_t e0 = s.find_last_not_of(" \t\r\n");
                return b0 == std::string::npos ? std::string()
                                               : s.substr(b0, e0 - b0 + 1);
            };
            a = trim(a);
            b = trim(b);
            if (a.empty() || b.empty()) continue;
            table[a].insert(b);
            int words = 1 + static_cast<int>(std::count(a.begin(), a.end(), ' '));
            max_phrase = std::max(max_phrase, words);
            words = 1 + static_cast<int>(std::count(b.begin(), b.end(), ' '));
            max_phrase = std::max(max_phrase, words);
        }
        return true;
    }
};

// Flat synonym table: "word id id ..." lines (word → WordNet synset-id
// set, morphological exceptions already folded in by the Python side —
// clipcap_tpu_torch/eval/meteor.py::_flat_synonyms_path).  Two words match at
// the synonym stage iff their id sets intersect.
struct SynonymTable {
    std::map<std::string, std::vector<long>> ids;  // sorted id vectors

    bool load(const std::string& path) {
        std::ifstream f(path);
        if (!f) return false;
        std::string line;
        while (std::getline(f, line)) {
            std::istringstream iss(line);
            std::string w;
            if (!(iss >> w)) continue;
            std::vector<long> v;
            long id;
            while (iss >> id) v.push_back(id);
            if (v.empty()) continue;
            std::sort(v.begin(), v.end());
            auto& dst = ids[w];
            dst.insert(dst.end(), v.begin(), v.end());
            std::sort(dst.begin(), dst.end());
            dst.erase(std::unique(dst.begin(), dst.end()), dst.end());
        }
        return true;
    }

    bool match(const std::string& a, const std::string& b) const {
        if (ids.empty()) return false;
        auto ia = ids.find(a);
        if (ia == ids.end()) return false;
        auto ib = ids.find(b);
        if (ib == ids.end()) return false;
        const auto& va = ia->second;
        const auto& vb = ib->second;
        size_t x = 0, y = 0;
        while (x < va.size() && y < vb.size()) {
            if (va[x] == vb[y]) return true;
            if (va[x] < vb[y]) ++x; else ++y;
        }
        return false;
    }
};

struct Scorer {
    ParaphraseTable paraphrases;
    SynonymTable synonyms;
    // The jar's function/en.words when supplied (one word per line);
    // otherwise the built-in closed-class list.
    std::set<std::string> fwords = function_words();

    bool load_function_words(const std::string& path) {
        std::ifstream f(path);
        if (!f) return false;
        std::set<std::string> out;
        std::string line;
        while (std::getline(f, line)) {
            size_t b0 = line.find_first_not_of(" \t\r\n");
            if (b0 == std::string::npos) continue;
            size_t e0 = line.find_last_not_of(" \t\r\n");
            std::string w = line.substr(b0, e0 - b0 + 1);
            if (w.empty() || w[0] == '#') continue;
            for (auto& ch : w)
                ch = static_cast<char>(std::tolower(static_cast<unsigned char>(ch)));
            out.insert(w);
        }
        fwords = std::move(out);
        return true;
    }

    double word_weight(const std::string& w) const {
        return fwords.count(w) ? (1.0 - DELTA) : DELTA;
    }
};

void add_phrase_candidates(const Scorer& sc,
                           const std::vector<std::string>& hyp,
                           const std::vector<std::string>& ref,
                           std::vector<Match>* cands) {
    if (sc.paraphrases.table.empty()) return;
    auto spans = [&](const std::vector<std::string>& words) {
        std::map<std::string, std::vector<std::pair<int, int>>> out;
        int maxp = sc.paraphrases.max_phrase;
        for (int a = 0; a < static_cast<int>(words.size()); ++a) {
            std::string phrase;
            for (int ln = 1; ln <= maxp && a + ln <= static_cast<int>(words.size()); ++ln) {
                if (ln > 1) phrase += ' ';
                phrase += words[a + ln - 1];
                out[phrase].push_back({a, ln});
            }
        }
        return out;
    };
    auto h_spans = spans(hyp), r_spans = spans(ref);
    std::set<std::tuple<int, int, int, int>> seen;
    auto emit = [&](const std::pair<int, int>& hl, const std::pair<int, int>& rl) {
        auto key = std::make_tuple(hl.first, hl.second, rl.first, rl.second);
        if (seen.count(key)) return;
        seen.insert(key);
        cands->push_back({hl.first, hl.second, rl.first, rl.second, 3});
    };
    for (const auto& hp : h_spans) {
        auto it = sc.paraphrases.table.find(hp.first);
        if (it == sc.paraphrases.table.end()) continue;
        for (const auto& rp : it->second) {
            auto rit = r_spans.find(rp);
            if (rit == r_spans.end()) continue;
            for (const auto& rl : rit->second)
                for (const auto& hl : hp.second) emit(hl, rl);
        }
    }
    for (const auto& rp : r_spans) {
        auto it = sc.paraphrases.table.find(rp.first);
        if (it == sc.paraphrases.table.end()) continue;
        for (const auto& hp2 : it->second) {
            auto hit = h_spans.find(hp2);
            if (hit == h_spans.end()) continue;
            for (const auto& hl : hit->second)
                for (const auto& rl : rp.second) emit(hl, rl);
        }
    }
}

std::vector<Match> candidates(const Scorer& sc,
                              const std::vector<std::string>& hyp,
                              const std::vector<std::string>& ref) {
    std::vector<Match> cands;
    std::vector<std::string> hs(hyp.size()), rs(ref.size());
    for (size_t i = 0; i < hyp.size(); ++i) hs[i] = clipcap_native::snowball_stem(hyp[i]);
    for (size_t j = 0; j < ref.size(); ++j) rs[j] = clipcap_native::snowball_stem(ref[j]);
    for (size_t i = 0; i < hyp.size(); ++i) {
        for (size_t j = 0; j < ref.size(); ++j) {
            if (hyp[i] == ref[j])
                cands.push_back({static_cast<int>(i), 1, static_cast<int>(j), 1, 0});
            else if (hs[i] == rs[j])
                cands.push_back({static_cast<int>(i), 1, static_cast<int>(j), 1, 1});
            else if (sc.synonyms.match(hyp[i], ref[j]))
                cands.push_back({static_cast<int>(i), 1, static_cast<int>(j), 1, 2});
        }
    }
    add_phrase_candidates(sc, hyp, ref, &cands);
    return cands;
}

int count_chunks(std::vector<Match> matches) {
    if (matches.empty()) return 0;
    std::sort(matches.begin(), matches.end(), [](const Match& a, const Match& b) {
        return a.h != b.h ? a.h < b.h : a.r < b.r;
    });
    int chunks = 1;
    for (size_t k = 1; k < matches.size(); ++k) {
        if (!(matches[k].h == matches[k - 1].h + matches[k - 1].hl &&
              matches[k].r == matches[k - 1].r + matches[k - 1].rl))
            ++chunks;
    }
    return chunks;
}

// Jar aligner objective, maximized lexicographically:
// (words covered, -chunks, -total |h-r| start distance).
struct Objective {
    int covered, neg_chunks, neg_dist;
    bool operator>(const Objective& o) const {
        if (covered != o.covered) return covered > o.covered;
        if (neg_chunks != o.neg_chunks) return neg_chunks > o.neg_chunks;
        return neg_dist > o.neg_dist;
    }
};

Objective objective(const std::vector<Match>& matches) {
    int covered = 0, dist = 0;
    for (const auto& m : matches) {
        covered += m.hl + m.rl;
        dist += std::abs(m.h - m.r);
    }
    return {covered, -count_chunks(matches), -dist};
}

struct State {
    Mask hm, rm;
    std::vector<Match> chosen;
    Objective obj;
};

std::vector<Match> align(const Scorer& sc,
                         const std::vector<std::string>& hyp,
                         const std::vector<std::string>& ref) {
    auto cands = candidates(sc, hyp, ref);
    std::sort(cands.begin(), cands.end(), [](const Match& a, const Match& b) {
        if (a.h != b.h) return a.h < b.h;
        if (a.r != b.r) return a.r < b.r;
        if (a.stage != b.stage) return a.stage < b.stage;
        if (a.hl != b.hl) return a.hl < b.hl;
        return a.rl < b.rl;
    });
    std::vector<State> beam;
    beam.push_back({Mask(), Mask(), {}, {0, -0, 0}});
    for (const auto& m : cands) {
        Mask hb = span_mask(m.h, m.hl), rb = span_mask(m.r, m.rl);
        size_t n = beam.size();
        for (size_t s = 0; s < n; ++s) {
            if ((beam[s].hm & hb).any() || (beam[s].rm & rb).any()) continue;
            State next = beam[s];
            next.hm |= hb;
            next.rm |= rb;
            next.chosen.push_back(m);
            next.obj = objective(next.chosen);
            beam.push_back(std::move(next));
        }
        if (beam.size() > static_cast<size_t>(BEAM_WIDTH)) {
            std::stable_sort(beam.begin(), beam.end(),
                             [](const State& a, const State& b) { return a.obj > b.obj; });
            beam.resize(BEAM_WIDTH);
        }
    }
    const State* best = &beam[0];
    for (const auto& s : beam)
        if (s.obj > best->obj) best = &s;
    return best->chosen;
}

}  // namespace

extern "C" {

// All three resource paths optional (NULL/empty = fall back: no
// paraphrase stage, inert synonym stage, built-in function words).
void* ccn_meteor_new(const char* paraphrase_path,
                     const char* function_words_path,
                     const char* synonyms_path) {
    auto* sc = new Scorer();
    if (paraphrase_path && paraphrase_path[0] != '\0') {
        if (!sc->paraphrases.load(paraphrase_path)) {
            delete sc;
            return nullptr;
        }
    }
    if (function_words_path && function_words_path[0] != '\0') {
        if (!sc->load_function_words(function_words_path)) {
            delete sc;
            return nullptr;
        }
    }
    if (synonyms_path && synonyms_path[0] != '\0') {
        if (!sc->synonyms.load(synonyms_path)) {
            delete sc;
            return nullptr;
        }
    }
    return sc;
}

void ccn_meteor_delete(void* handle) { delete static_cast<Scorer*>(handle); }

// out[7] = {matches_h, matches_r, chunks,
//           w_matched_h, w_matched_r, w_len_h, w_len_r}
void ccn_meteor_stats(void* handle, const char* hyp_c, const char* ref_c,
                      double* out) {
    const Scorer& sc = *static_cast<Scorer*>(handle);
    auto hyp = normalize(hyp_c ? hyp_c : "");
    auto ref = normalize(ref_c ? ref_c : "");
    auto matches = align(sc, hyp, ref);

    int mh = 0, mr = 0;
    double w_h = 0.0, w_r = 0.0;
    for (const auto& m : matches) {
        mh += m.hl;
        mr += m.rl;
        double sw = STAGE_WEIGHTS[m.stage];
        for (int k = 0; k < m.hl; ++k) w_h += sw * sc.word_weight(hyp[m.h + k]);
        for (int k = 0; k < m.rl; ++k) w_r += sw * sc.word_weight(ref[m.r + k]);
    }
    double len_h = 0.0, len_r = 0.0;
    for (const auto& w : hyp) len_h += sc.word_weight(w);
    for (const auto& w : ref) len_r += sc.word_weight(w);

    out[0] = mh;
    out[1] = mr;
    out[2] = count_chunks(matches);
    out[3] = w_h;
    out[4] = w_r;
    out[5] = len_h;
    out[6] = len_r;
}

double ccn_meteor_score_from_stats(const double* st) {
    double mh = st[0], mr = st[1], chunks = st[2];
    double w_h = st[3], w_r = st[4], len_h = st[5], len_r = st[6];
    if (mh == 0 || len_h == 0 || len_r == 0) return 0.0;
    double p = w_h / len_h, r = w_r / len_r;
    if (p == 0 || r == 0) return 0.0;
    double fmean = (p * r) / (ALPHA * p + (1 - ALPHA) * r);
    double frag = chunks > 0 ? chunks / (0.5 * (mh + mr)) : 0.0;
    double penalty = GAMMA * std::pow(frag, BETA);
    return (1.0 - penalty) * fmean;
}

// Porter (1980) stemmer exposed for cross-testing against the Python spec.
char* ccn_porter_stem(const char* word) {
    std::string out = clipcap_native::porter_stem(word ? word : "");
    char* p = static_cast<char*>(std::malloc(out.size() + 1));
    std::memcpy(p, out.c_str(), out.size() + 1);
    return p;
}

// Snowball stemmer exposed for cross-testing against the Python spec.
char* ccn_snowball_stem(const char* word) {
    std::string out = clipcap_native::snowball_stem(word ? word : "");
    char* p = static_cast<char*>(std::malloc(out.size() + 1));
    std::memcpy(p, out.c_str(), out.size() + 1);
    return p;
}

}  // extern "C"

// PTB-style caption tokenizer — C++ replacement for the reference's
// Java subprocess (edu.stanford.nlp.process.PTBTokenizer -preserveLines
// -lowerCase + the wrapper's punctuation strip,
// ClipCap's clipcap/eval/pycocoevalcap/tokenizer/ptbtokenizer.py).
//
// Behavior is the spec defined by clipcap_tpu_torch/eval/tokenization.py — the
// two are cross-tested for identical output. Hand-rolled scanner (no
// std::regex): lowercase → "cannot"/clitic splits → token scan → drop
// punctuation tokens.
#include <cctype>
#include <cstdlib>
#include <cstring>
#include <set>
#include <string>
#include <vector>

namespace {

bool is_alnum_l(char c) { return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9'); }

// NB the reference strip list is UPPERCASE ("-LRB-") but the Java
// tokenizer runs with -lowerCase, which lowercases the bracket escapes to
// "-lrb-" — in the real pipeline brackets SURVIVE the strip.  We reproduce
// that quirk: emit lowercase escapes, which don't match the strip list.
const std::set<std::string>& punct_set() {
    static const std::set<std::string> s = {
        "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
        ".", "?", "!", ",", ":", "-", "--", "...", ";",
    };
    return s;
}

std::string bracket_token(char c) {
    switch (c) {
        case '(': return "-lrb-"; case ')': return "-rrb-";
        case '{': return "-lcb-"; case '}': return "-rcb-";
        case '[': return "-lsb-"; case ']': return "-rsb-";
        default: return std::string(1, c);
    }
}

// Clitic suffixes checked at an apostrophe or at the 'n' of "n't"; the
// match needs a right word-boundary (mirrors the Python \b).
bool clitic_at(const std::string& t, size_t i, size_t* len) {
    if (t[i] == 'n' && i + 2 < t.size() && t[i+1] == '\'' && t[i+2] == 't') {
        if (i + 3 >= t.size() || !is_alnum_l(t[i+3])) { *len = 3; return true; }
    }
    if (t[i] != '\'') return false;
    static const char* clitics[] = {"'re", "'ve", "'ll", "'s", "'d", "'m"};
    for (auto* c : clitics) {
        size_t n = std::strlen(c);
        if (t.compare(i, n, c) == 0
            && (i + n >= t.size() || !is_alnum_l(t[i + n]))) {
            *len = n;
            return true;
        }
    }
    return false;
}

std::vector<std::string> tokenize_line(const std::string& input) {
    // 1. lowercase
    std::string text;
    text.reserve(input.size());
    for (char c : input) text += static_cast<char>(std::tolower(static_cast<unsigned char>(c)));

    // 2. assimilation splits (PTBLexer splitAssimilations): "cannot" ->
    //    "can not", "gonna" -> "gon na", etc. (word boundaries)
    struct Assim { const char* whole; const char* split; size_t len; };
    static const Assim assims[] = {
        {"cannot", "can not", 6}, {"gonna", "gon na", 5},
        {"wanna", "wan na", 5},   {"gotta", "got ta", 5},
        {"gimme", "gim me", 5},   {"lemme", "lem me", 5},
    };
    std::string t2;
    for (size_t i = 0; i < text.size();) {
        bool matched = false;
        for (const auto& a : assims) {
            if (text.compare(i, a.len, a.whole) == 0
                && (i == 0 || !is_alnum_l(text[i-1]))
                && (i + a.len >= text.size() || !is_alnum_l(text[i + a.len]))) {
                t2 += a.split;
                i += a.len;
                matched = true;
                break;
            }
        }
        if (!matched) t2 += text[i++];
    }

    // 3. separate clitics with a space: "dog's" -> "dog 's", "can't" -> "ca n't"
    std::string t3;
    for (size_t i = 0; i < t2.size();) {
        size_t len = 0;
        if (clitic_at(t2, i, &len)) {
            t3 += ' ';
            t3.append(t2, i, len);
            i += len;
        } else {
            t3 += t2[i++];
        }
    }

    // 4. scan tokens mirroring the Python _TOKEN regex alternation order:
    //    "..." | "--" | clitic | word([-'][word])* | single symbol
    std::vector<std::string> out;
    const std::string& t = t3;
    size_t i = 0;
    while (i < t.size()) {
        char c = t[i];
        if (std::isspace(static_cast<unsigned char>(c))) { ++i; continue; }
        std::string tok;
        if (t.compare(i, 3, "...") == 0) { tok = "..."; i += 3; }
        else if (t.compare(i, 2, "--") == 0) { tok = "--"; i += 2; }
        else {
            size_t clen = 0;
            size_t num_end = 0, acro_end = 0;
            // number with internal [.,:] groups: "3.5", "1,000", "2:30"
            if (c >= '0' && c <= '9') {
                size_t j = i;
                while (j < t.size() && t[j] >= '0' && t[j] <= '9') ++j;
                size_t groups = 0;
                while (j + 1 < t.size() && (t[j] == '.' || t[j] == ',' || t[j] == ':')
                       && t[j+1] >= '0' && t[j+1] <= '9') {
                    ++j;
                    while (j < t.size() && t[j] >= '0' && t[j] <= '9') ++j;
                    ++groups;
                }
                if (groups) num_end = j;
            }
            // letter acronym: ([a-z]\.){2,} — "u.s.", "a.m."
            if (c >= 'a' && c <= 'z') {
                size_t j = i, pairs = 0;
                while (j + 1 < t.size() && t[j] >= 'a' && t[j] <= 'z' && t[j+1] == '.') {
                    j += 2;
                    ++pairs;
                }
                if (pairs >= 2) acro_end = j;
            }
            if (num_end) { tok = t.substr(i, num_end - i); i = num_end; }
            else if (acro_end) { tok = t.substr(i, acro_end - i); i = acro_end; }
            else if (clitic_at(t, i, &clen)) { tok = t.substr(i, clen); i += clen; }
            else if (is_alnum_l(c)) {
                size_t j = i;
                while (j < t.size() && is_alnum_l(t[j])) ++j;
                // extend through -word or 'word groups
                while (j < t.size() && (t[j] == '-' || t[j] == '\'')
                       && j + 1 < t.size() && is_alnum_l(t[j+1])) {
                    ++j;
                    while (j < t.size() && is_alnum_l(t[j])) ++j;
                }
                tok = t.substr(i, j - i);
                i = j;
            } else if (static_cast<unsigned char>(c) >= 0x80) {
                // UTF-8 multibyte sequence → one symbol token (the Python
                // spec treats one non-ascii char as one token).
                size_t j = i + 1;
                while (j < t.size() && (static_cast<unsigned char>(t[j]) & 0xC0) == 0x80) ++j;
                tok = t.substr(i, j - i);
                i = j;
            } else {
                tok = bracket_token(c);
                ++i;
            }
        }
        if (punct_set().count(tok)) continue;
        out.push_back(tok);
    }
    return out;
}

}  // namespace

extern "C" {

// Tokenize one line; returns a malloc'd space-joined string (caller frees
// with ccn_free).
char* ccn_ptb_tokenize(const char* line) {
    auto toks = tokenize_line(line ? line : "");
    std::string joined;
    for (size_t i = 0; i < toks.size(); ++i) {
        if (i) joined += ' ';
        joined += toks[i];
    }
    char* out = static_cast<char*>(std::malloc(joined.size() + 1));
    std::memcpy(out, joined.c_str(), joined.size() + 1);
    return out;
}

void ccn_free(char* p) { std::free(p); }

}  // extern "C"

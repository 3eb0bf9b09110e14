// Oracle-only instrumentation harness. Compiles AGAINST the read-only
// reference tree (never shipped, never imported by the framework) to dump
// intermediate values of the reference kernels so the framework's golden
// model and device kernels can be validated bit-for-bit.
//
// Build (see oracle/build.sh):
//   g++ -O2 -msse2 -I/root/reference harness.cpp \
//       /root/reference/ssw_cpp.cpp /root/reference/sswNew.cpp -o bin/harness
//
// Modes:
//   thresh  <rna.txt> <seg.txt>                -> calc_score_once score
//   colmax  <rna.txt> <seg.txt>                -> ssw_pre_align scoreMatrix
//   align   <rna.txt> <win.txt>                -> ssw_align result + cigar
//   prealign <rna.txt> <seg.txt> <threshold>   -> clustered peak list
//   sim     <rna.txt> <seqT.txt> <src.txt> <min_score> <strand> <para>
//           <rule> [ntMin ntMax pT pC]         -> SIM triplex rows
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include "sim.h"        // reference exact engine (+ stats.h, rules.h)
#include "ssw_cpp.h"    // reference SSW wrapper
#include "ssw.h"

static std::string slurp(const char* path) {
    std::ifstream f(path);
    std::stringstream ss;
    ss << f.rdbuf();
    std::string s = ss.str();
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    return s;
}

int main(int argc, char** argv) {
    if (argc < 4) { fprintf(stderr, "usage: harness <mode> <rna> <seq> [thr]\n"); return 2; }
    std::string mode = argv[1];
    std::string rna = slurp(argv[2]);
    std::string seq = slurp(argv[3]);

    if (mode == "sim") {
        // Drive the reference SIM engine (sim.h:410) on one
        // (rna, transformed-seq, source-seq) triple with LongTarget's
        // fixed scoring args (Fasim-LongTarget.cpp:423-425).
        std::string src = slurp(argv[4]);
        long min_score = atol(argv[5]);
        long strand = atol(argv[6]);
        long para = atol(argv[7]);
        long rule = atol(argv[8]);
        int nt_min = argc > 9 ? atoi(argv[9]) : 20;
        int nt_max = argc > 10 ? atoi(argv[10]) : 100000;
        int pT = argc > 11 ? atoi(argv[11]) : -1000;
        int pC = argc > 12 ? atoi(argv[12]) : 0;
        std::vector<struct triplex> out;
        SIM(rna, seq, src, 0, min_score, 5, -4, -12, -4, out, strand, para,
            rule, nt_min, nt_max, pT, pC);
        for (auto& t : out)
            printf("%d %d %d %d %d %d %d %d %.6g %.6g %.6g %s %s\n",
                   t.stari, t.endi, t.starj, t.endj, t.strand, t.reverse,
                   t.rule, t.nt, t.score, t.identity, t.tri_score,
                   t.stri_align.c_str(), t.strj_align.c_str());
        return 0;
    }

    if (mode == "thresh") {
        int score = calc_score_once(rna, seq, 0, 0);
        printf("%d\n", score);
        return 0;
    }

    StripedSmithWaterman::Aligner aligner;   // forked defaults 5/4/16/4
    StripedSmithWaterman::Filter filter;
    StripedSmithWaterman::Alignment alignment;

    if (mode == "colmax") {
        // Reproduce preAlign up to the raw scoreMatrix (ssw_cpp.cpp:388-457).
        static const int8_t nt[128] = {
            4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
            4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
            4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,0,4,4,4,4,4,4,4,4,4,4,
            4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,0,4,4,4,4,4,4,4,4,4,4};
        static const int8_t mat[25] = {
            5,-4,-4,-4,-4, -4,5,-4,-4,-4, -4,-4,5,-4,-4, -4,-4,-4,5,-4,
            -4,-4,-4,-4,-4};
        std::vector<int8_t> q(rna.size()), r(seq.size());
        for (size_t i = 0; i < rna.size(); i++) q[i] = nt[(int)rna[i] & 127];
        for (size_t i = 0; i < seq.size(); i++) r[i] = nt[(int)seq[i] & 127];
        s_profile* prof = ssw_init(q.data(), (int)q.size(), mat, 5, 2);
        int* sm = ssw_pre_align(prof, r.data(), (int)r.size(), 16, 4, 0x0f, 0,
                                32767, 15, 0);
        for (size_t i = 0; i < seq.size(); i++) printf("%d\n", sm[i]);
        return 0;
    }

    if (mode == "prealign") {
        int thr = atoi(argv[4]);
        std::vector<StripedSmithWaterman::scoreInfo> peaks;
        aligner.preAlign(rna.c_str(), seq.c_str(), (int)seq.size(), filter,
                         &alignment, 15, thr, peaks, 5, -4);
        for (auto& p : peaks) printf("%d %d\n", p.score, p.position);
        return 0;
    }

    if (mode == "align") {
        aligner.Align(rna.c_str(), seq.c_str(), (int)seq.size(), filter,
                      &alignment, 15);
        printf("%d %d %d %d %d %s\n", alignment.sw_score, alignment.query_begin,
               alignment.query_end, alignment.ref_begin, alignment.ref_end,
               alignment.cigar_string.c_str());
        return 0;
    }
    fprintf(stderr, "unknown mode\n");
    return 2;
}
